"""Phase 11's sharded forward and its one-card forward, both held against
the same weights run in float64, block by block.

Four ranks (one a card, over NCCL; with ``--cpu``, four processes over
gloo) take phase 11's seeded weights and forward batch
(``chip_smoke._p11_draw``, ``_p11_batch``). Rank 0 runs the one-card
model in f32 on its device, in f32 on the CPU, and in f64 on the CPU
(every f32 cast of the model promoted to f64, the kernels' plain
versions). Every rank runs the sharded model on the (1, 4) and (2, 2)
meshes. Rank 0 prints, for the residual stream after every block and
for the logits, max |d| / max |x_f64| of each f32 run against f64, and
of each sharded run against the one-card run (phase 11's reading).

Then it runs every mLSTM block alone from its f64 input, f32 on the
device against f64 on the CPU, and prints where the cell's per-head
group norm is off most: the normaliser's two terms max(|n.q|,
exp(-m)), the mean square entering the norm (beside its 1e-6), and the
numerator's relative error there::

    chiprun --chips 4 --timeout 600 -- env PYTHONPATH=src \\
        python tools/p11_against_f64.py xlstm-125m
    PYTHONPATH=src python tools/p11_against_f64.py xlstm-125m --cpu

It builds the kernels first on a card. A run on the CPU draws other
weights than one on a card (the generators differ by device).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import Float64  # noqa: E402

WORLD = 4


class Ops(TorchFunctionMode):
    """Every call's function, arguments and output, in order."""

    def __init__(self, log: list):
        super().__init__()
        self.log = log

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.log.append((func, args, out))
        return out


def _rel(got: torch.Tensor, exp: torch.Tensor) -> float:
    got, exp = got.detach().cpu().double(), exp.detach().cpu().double()
    return float((got - exp).abs().max() / exp.abs().max())


def _cell_parts(log: list) -> dict:
    """The mLSTM cell's normaliser ``max(|n.q|, exp(-m))`` (its one
    ``maximum`` of two tensors of one shape), its numerator (the one
    division by a tensor) and what enters the group norm (its
    ``square``, the last)."""
    def name(func):
        return getattr(func, "__name__", "")

    nq, floor = [a for func, a, _ in log if name(func) == "maximum"
                 and isinstance(a[1], torch.Tensor)
                 and a[0].shape == a[1].shape][-1]
    num = next(a[0] for func, a, _ in log
               if name(func) in ("div", "__truediv__") and len(a) == 2
               and isinstance(a[1], torch.Tensor))
    normed = [a[0] for func, a, _ in log if name(func) == "square"][-1]
    return {"nq": nq, "floor": floor, "num": num, "in": normed}


def _cells(cfg, full: dict, ins: list, dev) -> list:
    """Every mLSTM block alone, from its f64 input: the cell in f32 on
    ``dev`` against f64 on the CPU. For each, the error after the
    per-head group norm and at the block's output, and at the (row,
    token, head) where the former peaks: the normaliser's two terms
    (which one binds), the mean square of what enters the norm (against
    the norm's 1e-6), and the relative error there of the numerator."""
    from repro_torch.models.model import _index
    out = []
    i = 0
    for seg_i, seg in enumerate(cfg.segments):
        for r in range(seg.repeat):
            for bi, block in enumerate(seg.blocks):
                if block.kind == "mlstm":
                    p = _index(full["segments"][seg_i][bi], r)
                    out.append({"block": i, **_cell(cfg, p, ins[i], dev)})
                i += 1
    return out


def _cell(cfg, p: dict, x64: torch.Tensor, dev) -> dict:
    from repro_torch.models import layers as L
    runs = {}
    with torch.no_grad():
        for name, d, wrap in (("f32", dev, Ops), ("f64", "cpu", Float64)):
            dt = torch.float64 if name == "f64" else torch.float32
            pp = _tree_to(p, d, dt)
            log: list = []
            with wrap(log):
                h = L.rmsnorm(pp["norm1"], cfg, x64.to(d, dt))
                y = L.mlstm_block(pp["core"], cfg, h)
            parts = {k: v.detach().cpu().double()
                     for k, v in _cell_parts(log).items()}
            x = parts["in"]
            parts["ms"] = x.square().mean(-1)
            parts["normed"] = x * torch.rsqrt(parts["ms"][..., None] + 1e-6)
            parts["out"] = y.detach().cpu().double()
            runs[name] = parts
    a, e = runs["f32"], runs["f64"]
    err = (a["normed"] - e["normed"]).abs()
    at = tuple(int(i) for i in torch.nonzero(err == err.max())[0][:3])
    b, s, h, _ = e["in"].shape
    num32, num64 = (t["num"].reshape(b, s, h, -1)[at] for t in (a, e))
    return {
        "normed_rel": _rel(a["normed"], e["normed"]),
        "out_rel": _rel(a["out"], e["out"]),
        "at": list(at),
        "nq": float(e["nq"][at]), "floor": float(e["floor"][at]),
        "mean_square": float(e["ms"][at]),
        "median_mean_square": float(e["ms"].median()),
        "num_rel": float((num32 - num64).abs().max() / num64.abs().max()),
    }


def _forward(model, params, batch, par=None, ins: list = None) -> list:
    """The residual stream after every block, then the logits; with
    ``ins``, each block's input is appended to it."""
    from repro_torch.models import model as M
    kept = []
    apply = M._apply_block

    def rec(p, cfg, block, x, *args, **kwargs):
        if ins is not None:
            ins.append(x.detach().cpu().double())
        out = apply(p, cfg, block, x, *args, **kwargs)
        kept.append(out[0].detach())
        return out

    M._apply_block = rec
    try:
        with torch.no_grad():
            logits, _ = model.forward(params, batch)
    finally:
        M._apply_block = apply
    if par is not None:
        logits = model.gather_logits(logits)
        kept = [par.all_gather(t, 0, "data") for t in kept]
        logits = par.all_gather(logits, 0, "data")
    return [t.cpu().double() for t in kept + [logits]]


def _rank(rank: int, store: str, args) -> None:
    import chip_smoke as c
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.parallel import (ShardedModel, shard_batch,
                                             shard_params)
    import numpy as np

    if args.cpu:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or WORLD) // WORLD))
        dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                                rank=rank, world_size=WORLD)
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load(rebuild=False)
        dist.init_process_group(
            "nccl", store=dist.FileStore(store, WORLD), rank=rank,
            world_size=WORLD, timeout=datetime.timedelta(seconds=300),
            device_id=dev)
    cfg = get_arch(args.arch)
    full = c._p11_draw(cfg, dev)
    rng = np.random.default_rng(11)
    fwd = c._p11_batch(cfg, torch.from_numpy(rng.integers(
        0, cfg.vocab_size, c.PAR_FWD)).to(dev), 12)
    runs = {}
    if rank == 0:
        cpu = torch.device("cpu")
        runs["one card f32"] = _forward(build_model(cfg, dev), full, fwd)
        plain = build_model(cfg, cpu)
        on_cpu = {k: v.cpu() for k, v in fwd.items()}
        runs["CPU f32"] = _forward(plain, _tree_to(full, cpu), on_cpu)
        ins64: list = []
        with Float64():
            runs["CPU f64"] = _forward(
                plain, _tree_to(full, cpu, torch.float64), on_cpu, ins=ins64)
    for shape in c.PAR_MESHES:
        mesh = make_mesh(*shape)
        model = ShardedModel(cfg, mesh, dev)
        out = _forward(model, shard_params(full, mesh),
                       shard_batch(fwd, mesh), model.par)
        if rank == 0:
            runs[f"({shape[0]}, {shape[1]}) f32"] = out
        del model
        dist.barrier()
    if rank == 0:
        ref, one = runs["CPU f64"], runs["one card f32"]
        names = [b.kind for seg in cfg.segments
                 for _ in range(seg.repeat) for b in seg.blocks]
        rows = []
        for i, x in enumerate(ref):
            row = {"at": names[i] if i < len(names) else "logits",
                   "max_abs": float(x.abs().max())}
            for name, r in runs.items():
                if name != "CPU f64":
                    row[f"{name} vs f64"] = _rel(r[i], x)
            for name, r in runs.items():
                if name.startswith("("):
                    row[f"{name} vs one card"] = _rel(r[i], one[i])
            rows.append(row)
        report = {"arch": cfg.name, "device": str(dev), "blocks": rows}
        report["cells"] = _cells(cfg, full, ins64, dev)
        keys = [k for k in rows[0] if k not in ("at", "max_abs")]
        print(f"{cfg.name} on {dev}: max |d| / max |x_f64| by block")
        print(" ".join(["block", "kind  ", "max|x|   "] +
                       [f"{k:>24s}" for k in keys]))
        for i, row in enumerate(rows):
            print(" ".join([f"{i:5d}", f"{row['at']:6s}",
                            f"{row['max_abs']:9.3e}"] +
                           [f"{row[k]:24.3e}" for k in keys]))
        if report["cells"]:
            print("each mLSTM block alone from its f64 input, f32 on "
                  f"{dev} against f64: where the group norm's output "
                  "is off most")
            print("block  normed    output    (row, token, head)  |n.q|"
                  "      exp(-m)    mean sq.   median     numerator")
            for c in report["cells"]:
                print(f"{c['block']:5d}  {c['normed_rel']:.2e}  "
                      f"{c['out_rel']:.2e}  {str(tuple(c['at'])):18s}  "
                      f"{c['nq']:.3e}  {c['floor']:.3e}  "
                      f"{c['mean_square']:.3e}  "
                      f"{c['median_mean_square']:.3e}  {c['num_rel']:.2e}")
        print(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def _tree_to(tree, dev, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to(v, dev, dtype) for v in tree)
    return tree.to(dev, dtype or tree.dtype)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="xlstm-125m")
    ap.add_argument("--cpu", action="store_true",
                    help="four processes over gloo, no card")
    args = ap.parse_args()
    if not args.cpu:
        from repro_torch.kernels import _build
        _build.load()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(os.path.join(tmp, "store"), args),
                 nprocs=WORLD)


if __name__ == "__main__":
    main()
