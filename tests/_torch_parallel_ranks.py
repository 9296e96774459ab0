"""One rank of the sharded-model checks in ``tests/test_torch_parallel.py``.

Run as ``python tests/_torch_parallel_ranks.py RANK DATA MODEL WORKDIR
[cuda]`` by that test, DATA x MODEL times, one process a rank (gloo over
a ``FileStore`` in WORKDIR; with ``cuda``, NCCL and one card a rank, as
``tests/test_torch_gpu.py`` runs it). It reads ``WORKDIR/inputs.pkl`` (per case:
the full parameter tree as numpy, the batch, the prompt, and the stub
frames or image features of each: ``feats`` and ``prompt_feats``) and
rank 0 writes ``WORKDIR/out_DATAxMODEL.pkl``: the gathered logits,
greedy tokens, loss, gradients (each in the reference's shape) and the
global gradient norm of each case. Imports no JAX.
"""

import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.parallel import (  # noqa: E402
    _map2,
    build_sharded,
    shard_batch,
    shard_params,
)
from repro_torch.train import AdamW, make_train_step  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def gather_leaf(local: torch.Tensor, spec, par) -> torch.Tensor:
    """A whole leaf from its shards (every rank gets it)."""
    for d, entry in enumerate(spec):
        if entry is not None:
            local = par.all_gather(local, d, entry)
    return local


def run_case(case: dict, mesh, device: torch.device) -> dict:
    cfg = case["cfg"]
    over_data = case.get("over_data", True)
    model = build_sharded(cfg, mesh, device, batch_over_data=over_data)
    par = model.par
    full = params_from_numpy(case["params"], "cpu")
    params = shard_params(full, mesh, device=device)
    out: dict = {}

    def rows(name):
        batch = {"tokens": torch.from_numpy(case[name]).to(device)}
        for k, v in case.get({"tokens": "feats",
                              "prompt": "prompt_feats"}[name], {}).items():
            batch[k] = torch.from_numpy(v).to(device)
        return shard_batch(batch, mesh) if over_data else batch

    def whole(x):
        return par.all_gather(x, 0, "data") if over_data else x

    with torch.no_grad():
        batch = rows("tokens")
        logits, aux = model.forward(params, batch)
        logits = whole(model.gather_logits(logits))
        out["logits"], out["aux"] = _np(logits), float(aux)

        logits, state = model.prefill(params, rows("prompt"), case["smax"],
                                      shard_seq=case.get("shard_seq", False))
        step_logits = [model.gather_logits(logits)]
        tok = step_logits[-1].argmax(-1)
        toks = [tok]
        # a step's position counts an image prefix
        pos = case["prompt"].shape[1] + cfg.num_image_tokens
        for i in range(case["steps"]):
            logits, state = model.decode_step(params, tok, pos + i, state)
            step_logits.append(model.gather_logits(logits))
            tok = step_logits[-1].argmax(-1)
            toks.append(tok)
        out["step_logits"] = _np(whole(torch.cat(step_logits, 1)))
        out["tokens"] = whole(torch.cat(toks, 1)).cpu().numpy()

    seen = []

    class Recording(AdamW):
        def update(self, params, state, grads, sq_norm=None):
            seen.append((grads, float(sq_norm(grads))))
            return super().update(params, state, grads, sq_norm)

    opt = Recording(lr=1e-3)
    step = make_train_step(model, opt)
    _, _, metrics = step(params, opt.init(params), rows("tokens"))
    grads, sq = seen[0]
    spec_of = {}
    _map2(lambda g, s: spec_of.__setitem__(id(g), s), grads, model.specs)
    out["loss"] = float(metrics["loss"])
    out["grad_sq_norm"] = sq
    # in jax.tree_util's leaf order (dict keys sorted), each in the
    # reference's shape (Mamba's in_proj and mLSTM's up run as (D, 2,
    # D_in))
    out["grads"] = [_np(gather_leaf(g, spec_of[id(g)], par).reshape(
        f.shape)) for g, f in zip(leaves(grads), leaves(full))]
    return out


def main() -> None:
    rank, data, model, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    cuda = sys.argv[5:] == ["cuda"]
    torch.set_num_threads(1)
    world = data * model
    tag = f"{data}x{model}"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        store=dist.FileStore(os.path.join(workdir, f"store_{tag}"), world),
        rank=rank, world_size=world)
    mesh = make_mesh(data, model)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        cases = pickle.load(f)
    results: dict = {}
    for name, case in cases.items():
        try:
            results[name] = run_case(case, mesh, device)
        except Exception:  # noqa: BLE001 - reported per case
            results[name] = {"error": traceback.format_exc()}
    if rank == 0:
        path = os.path.join(workdir, f"out_{tag}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(path + ".tmp", path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
