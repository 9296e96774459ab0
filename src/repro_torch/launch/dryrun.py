"""The multi-pod dry-run on the ``meta`` device: the reference's
``repro/launch/dryrun.py`` for the port.

For each (architecture x input shape x mesh) it starts the ``fake``
process-group backend at the mesh's world size (256 for the 16 x 16
pod, 512 for 2 x 16 x 16), builds this rank's local shards as ``meta``
tensors (shapes, no storage) and runs the shape's step on them: the
train step of ``make_train_step`` with ``AdamW`` and the reference's
microbatch rule, ``prefill``, or one ``decode_step`` against a full
cache. It runs under ``FlopCounterMode`` and a live-bytes tracker of its
own (a ``TorchDispatchMode`` that follows every storage the step
allocates until it dies), inside :func:`repro_torch.kernels.meta.
shapes_only`, where the kernels give their outputs' true shapes and add
their FLOPs. The numbers are one rank's, measured against one H100's
80 GB and its roofline constants (:mod:`repro_torch.roofline.analysis`).

Nothing is compiled, so ``compile_s`` is 0 and ``lower_s`` is the time
of the traced step. The memory is what the step's tensors occupy at
their peak (parameters, optimizer state, batch and cache resident, plus
the step's live tensors), not an allocator's reserve. The batches are
the reference's ``batch_specs`` (whisper's stub frames, pixtral's stub
image features beside the tokens); a combination the reference skips
(long_500k on a full-attention architecture) is recorded as
``"skipped"`` with its reason.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summary
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.kernels import meta
from repro_torch.launch.mesh import MULTI, SINGLE
from repro_torch.launch.shapes import (
    SHAPES,
    ShapeSpec,
    applicable,
    batch_specs,
    dryrun_config,
)
from repro_torch.models.config import ArchConfig
from repro_torch.models.kvcache import init_cache
from repro_torch.models.parallel import ShardedModel
from repro_torch.models.sharding import MODEL
from repro_torch.roofline.analysis import (
    HBM_BYTES,
    model_flops_estimate,
    roofline_terms,
)
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import make_train_step
from repro_torch.train.tree import leaves

# long_500k runs for these archs only; the -sw variant substitutes for
# llama3.2-1b on that shape
LONG_CONTEXT_SUBSTITUTE = {"llama3.2-1b": "llama3.2-1b-sw"}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
META = torch.device("meta")
# funcol wraps a collective's result for autograd: an alias on a real
# backend, a fresh empty_like in its meta implementation; not counted
WRAP_OP = "_c10d_functional::_wrap_tensor_autograd"
MeshArg = Union[str, Tuple[int, ...]]


class DeviceBytes(TorchDispatchMode):
    """Live bytes of the storages the traced step allocates (each
    counted once, from its first output until it dies), their peak, and
    the bytes every operation reads and writes (inputs and outputs; views
    move nothing)."""

    def __init__(self, resident=()):
        super().__init__()
        self.live = self.peak = 0
        self.accessed = 0.0
        # storages that exist before the step (parameters, optimizer
        # state, cache, batch): counted apart, never as allocations
        self._keys: set = {t.untyped_storage()._cdata for t in resident}

    def _free(self, key: int, n: int) -> None:
        self._keys.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.name() == WRAP_OP:
            return out
        if not getattr(func, "is_view", False):
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.accessed += t.numel() * t.element_size()
        for t in tree_leaves(out) if not getattr(func, "is_view",
                                                 False) else ():
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._keys:
                continue
            n = st.nbytes()
            self._keys.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _mesh_dims(mesh: MeshArg) -> Tuple[str, Tuple[int, ...], Tuple[str, ...]]:
    """(name, shape, axis names) of ``"single"``, ``"multi"`` or a
    ``(data, model)`` pair."""
    if mesh == "single":
        return "single", SINGLE[0], SINGLE[1]
    if mesh == "multi":
        return "multi", MULTI[0], MULTI[1]
    data, model = mesh
    return f"{data}x{model}", (data, model), ("data", "model")


def _fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """The mesh over a ``fake`` group of its world size, this process
    rank 0 (the group is process-global: one of another size is ended
    first)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _analytic_bytes_per_device(cfg, shape: ShapeSpec, chips: int,
                               data_size: int, big: bool,
                               cache_bytes: int) -> float:
    """Per-device HBM-traffic floor for one step, the reference's
    (``dryrun.py:81-107``) with the cache sized from the ``meta`` cache
    tree (``cache_bytes``, the whole cache's bytes) instead of
    ``kvcache.cache_bytes``, which counts recurrent state twice."""
    n = cfg.param_count()
    p_bytes = 2.0 * n                      # bf16 params
    if shape.kind == "train":
        m_item = 2 if big else 4
        traffic = (3 * p_bytes + p_bytes + 2 * 2 * m_item * n) / chips
        toks_pd = shape.batch * shape.seq / data_size
        traffic += 2 * 2 * toks_pd * cfg.d_model * cfg.num_layers
        return traffic
    factor = 2.0 if shape.kind == "decode" else 1.0
    return p_bytes / chips + factor * cache_bytes / data_size


def lower_one(arch: Union[str, ArchConfig], shape: Union[str, ShapeSpec],
              mesh: MeshArg = "single", smax: int = 0,
              verbose: bool = True) -> Dict[str, Any]:
    """Trace one combination on ``meta``; returns the artifact dict.
    ``arch`` is a registered name, whose config takes the reference's
    production policy (:func:`dryrun_config`: bf16 parameters and
    compute, remat for training), or a config of the caller's, traced
    as it is: its dtypes, remat and routing groups (bf16 moments and
    microbatches still follow the reference's rule on its size).
    ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec`` of one's own;
    ``smax`` (prefill only) sizes the cache, by default the sequence and
    an image prefix, as the reference's."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    mesh_name, mesh_shape, axis_names = _mesh_dims(mesh)
    given = arch if isinstance(arch, ArchConfig) else None
    if given is not None:
        arch = given.name
    arch_eff = LONG_CONTEXT_SUBSTITUTE.get(arch, arch) \
        if shape.name == "long_500k" and given is None else arch
    base = given or get_arch(arch_eff)
    head = {"arch": arch, "arch_effective": arch_eff, "shape": shape.name,
            "mesh": mesh_name}
    ok, why = applicable(base, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}

    dmesh = _fake_mesh(mesh_shape, axis_names)
    chips = dmesh.size()
    sizes = dict(zip(axis_names, mesh_shape))
    data_size = chips // sizes[MODEL]
    cfg, big = dryrun_config(base, shape, data_size)
    if given is not None:
        cfg = given
    over_data = shape.batch % data_size == 0
    model = ShardedModel(cfg, dmesh, META, batch_over_data=over_data)
    b_local = shape.batch // data_size if over_data else shape.batch
    # this rank's rows of the reference's batch
    batch = {k: torch.empty((b_local,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device=META)
             for k, v in batch_specs(cfg, shape).items()}
    smax = smax or shape.seq + cfg.num_image_tokens

    t0 = time.time()
    params = model.init_local()
    kept = leaves(params)           # what the step finds resident
    param_bytes = _tree_bytes(params)
    tokens_total = shape.batch * shape.seq
    cache_full = 0
    run = None
    if shape.kind == "train":
        opt = AdamW(moment_dtype="bfloat16" if big else None)
        opt_state = opt.init(params)
        kept += leaves(opt_state)
        micro = max(1, shape.batch // data_size) if big else 1
        step = make_train_step(model, opt, microbatches=micro,
                               accum_dtype="bfloat16" if big else None)
        kept += leaves(batch)

        def run():
            return step(params, opt_state, batch)[2]["loss"]
    elif shape.kind == "prefill":
        kept += leaves(batch)
        # the cache's layout, set up outside the traced step (the step
        # allocates the local cache itself)
        model.init_cache(shape.batch, smax, device=META)
        cache_full = _tree_bytes(init_cache(cfg, shape.batch, smax,
                                            device=META)[0])

        def run():
            with torch.no_grad():
                return model.prefill(params, batch, smax)
    else:
        shard_seq = shape.batch == 1
        state = model.init_cache(shape.batch, shape.seq, shard_seq=shard_seq,
                                 device=META)
        kept += leaves(state[:2])
        cache_full = _tree_bytes(init_cache(cfg, shape.batch, shape.seq,
                                            device=META)[0])
        token = torch.empty((b_local, 1), dtype=torch.int32, device=META)
        kept.append(token)
        tokens_total = shape.batch

        def run():
            with torch.no_grad():
                return model.decode_step(params, token, shape.seq - 1,
                                         state)

    resident = _tree_bytes(kept)
    model.par.stats.reset()
    with meta.shapes_only(), FlopCounterMode(display=False) as fc, \
            DeviceBytes(kept) as mem:
        out = run()
        kernel_flops, kernel_bytes = meta.flops(), meta.nbytes()
        out_bytes = sum(t.numel() * t.element_size()
                        for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
        del out
    t_lower = time.time() - t0

    flops = float(fc.get_total_flops()) + kernel_flops
    by_kind = dict.fromkeys(COLLECTIVES, 0)
    by_kind.update(model.par.stats.bytes_by_kind())
    peak = resident + mem.peak
    mf = model_flops_estimate(cfg.active_param_count(), tokens_total,
                              shape.kind)
    ab = _analytic_bytes_per_device(cfg, shape, chips, data_size, big,
                                    cache_full)
    report = roofline_terms(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops=flops, bytes_accessed=mem.accessed + kernel_bytes,
        collectives_by_kind=by_kind, model_flops=mf, peak_mem=peak,
        analytic_bytes=ab)
    art = {
        **head, "status": "ok", "chips": chips,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "memory_analysis": {
            "argument_size_in_bytes": int(resident),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(mem.peak),
            "generated_code_size_in_bytes": 0,
        },
        "param_bytes_per_device": int(param_bytes),
        "peak_bytes_per_device": int(peak),
        "hbm_bytes": HBM_BYTES,
        "fits_hbm": bool(peak <= HBM_BYTES),
        "kernel_flops": kernel_flops,
        "collective_calls": {f"{k}/{n}": c for (k, n), (c, _)
                             in model.par.stats.by_kind.items()},
        "roofline": report.to_json(),
    }
    if verbose:
        r = art["roofline"]
        print(f"[{arch} x {shape.name} x {mesh_name}] traced "
              f"{t_lower:.1f}s  flops={r['hlo_flops']:.3e} "
              f"coll={r['collective_bytes']:.3e}B peak="
              f"{peak / 1e9:.2f}GB bottleneck={r['bottleneck']}",
              flush=True)
    return art


def summary(out_dir: str) -> str:
    """A markdown table of the artifacts in ``out_dir``, a row per arch
    x shape: each mesh's per-device peak (GB, against one H100's 80)
    and the roofline term that bounds it, with the three terms in ms
    (compute / memory / collective); skipped combinations are counted
    below it."""
    cells: Dict[Tuple[str, str], Dict[str, str]] = {}
    skipped = 0
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            art = json.load(f)
        if art["status"] != "ok":
            skipped += art["status"] == "skipped"
            continue
        r = art["roofline"]
        cells.setdefault((art["arch"], art["shape"]), {})[art["mesh"]] = (
            f"{art['peak_bytes_per_device'] / 1e9:.2f} GB, {r['bottleneck']}"
            f" ({r['t_compute_s'] * 1e3:.1f} / {r['t_memory_s'] * 1e3:.1f}"
            f" / {r['t_collective_s'] * 1e3:.1f})")
    rows = ["| arch | shape | 16 x 16 | 2 x 16 x 16 |",
            "| --- | --- | --- | --- |"]
    for (arch, shape), by in sorted(cells.items()):
        rows.append(f"| {arch} | {shape} | {by.get('single', '-')} | "
                    f"{by.get('multi', '-')} |")
    rows.append(f"\n{skipped} skipped")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS,
                    help="single architecture (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--summary", action="store_true",
                    help="print the table of the artifacts in --out")
    args = ap.parse_args()
    if args.summary:
        print(summary(args.out))
        return

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for mesh in meshes:               # one fake group a mesh size
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{mesh}"
                try:
                    art = lower_one(arch, shape, mesh)
                    if art["status"] == "ok":
                        n_ok += 1
                    else:
                        n_skip += 1
                        print(f"[{tag}] SKIP: {art['reason']}", flush=True)
                except Exception as e:  # noqa: BLE001 - recorded
                    n_fail += 1
                    art = {"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "fail", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    print(f"[{tag}] FAIL: {e}", flush=True)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(art, f, indent=1)
    print(f"dry-run complete: ok={n_ok} skipped={n_skip} failed={n_fail}",
          flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
