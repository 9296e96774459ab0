#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit, build the CUDA kernels;
2. hold each kernel against its plain PyTorch version on the card, at
   the served shapes and at edge shapes (f32 2e-5/2e-5, bf16 3e-2/3e-2),
   and time kernel, plain version and one PyTorch library call;
3. check the port's forward on the card against its plain CPU path on
   the smoke configs, build both cascade stages at full published width
   (xlstm-125m 12L x 768, llama3.2-1b 16L x 2048, seeded random
   weights) and profile them at batch sizes 1-16 on ``h100-1``;
4. serve a Poisson trace through the two-stage executor, with every
   kernel launch counter zeroed just before and read just after, and
   check every answer;
5. trace one batch per stage with torch.profiler: the device's busy
   share of the stage's batch latency and the kernels that fill it.

The line before the last is a JSON object with one record per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.hardware import (  # noqa: E402
    H100_HBM_BW,
    H100_PEAK_FLOPS_BF16,
    H100_PEAK_FLOPS_F32,
)
from repro_torch.core.pipeline import (  # noqa: E402
    PipelineConfig,
    StageConfig,
    linear_pipeline,
)
from repro_torch.core.profiler import (  # noqa: E402
    ProfileStore,
    profile_model_measured,
)
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import SEQ, PipelineExecutor, make_stage  # noqa: E402
from repro_torch.workload import gamma_trace  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
PEAK = {torch.float32: H100_PEAK_FLOPS_F32,
        torch.bfloat16: H100_PEAK_FLOPS_BF16}
SERVE_BATCH = 8                 # StageConfig.batch_size of the served run
SERVE_QPS, SERVE_S, SLO_S = 20.0, 10.0, 0.25
PROFILE_BATCHES = (1, 2, 4, 8, 16)
STAGES = ("xlstm-125m", "llama3.2-1b")


def launches_per_forward(cfg) -> dict:
    """A norm before every block's core and before its MLP, plus the
    final norm (33 for llama3.2-1b, 13 for xlstm-125m); one flash
    attention per attention block."""
    blocks = [b for seg in cfg.segments for b in seg.blocks
              for _ in range(seg.repeat)]
    return {"rmsnorm": len(blocks) + sum(b.ffn == "dense" for b in blocks)
            + 1,
            "flash_attention": sum(b.kind == "attn" for b in blocks)}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time per call over back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def assert_close(got: torch.Tensor, exp: torch.Tensor, dtype,
                 what: str) -> float:
    err = float((got.float() - exp.float()).abs().max()) if got.numel() \
        else 0.0
    torch.testing.assert_close(got.float(), exp.float(), **TOL[dtype],
                               msg=lambda m: f"{what}: {m}")
    return err


# ---------------------------------------------------------------- phase 2

def check_rmsnorm(gen: torch.Generator) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for d in (768, 2048):
            for rows in (32, 512, 7):
                x = rand(gen, (rows, d), dtype)
                g = rand(gen, (d,), dtype)
                got = rms_mod.rmsnorm(x, g)
                torch.cuda.synchronize()
                err = assert_close(got, ref.rmsnorm_ref(x, g), dtype,
                                   f"rmsnorm rows={rows} D={d} {dtype}")
                log(f"  rmsnorm  rows={rows:4d} D={d:4d} {str(dtype):14s} "
                    f"max_abs_err={err:.3e}  ok")


FLASH_CASES = (
    # (name, b, sq, sk, h, kv, d, dv, causal, window)
    ("llama B=1", 1, 32, 32, 32, 8, 64, 64, True, 0),
    ("llama B=8", 8, 32, 32, 32, 8, 64, 64, True, 0),
    ("Sq<Sk", 1, 64, 160, 32, 8, 64, 64, True, 0),
    ("window 16", 2, 96, 96, 8, 2, 64, 64, True, 16),
    ("D!=Dv", 1, 64, 64, 4, 2, 128, 64, True, 0),
    ("D!=Dv small", 2, 48, 48, 4, 1, 64, 32, True, 0),
    ("ragged 40x40", 2, 40, 40, 4, 2, 64, 64, True, 0),
    ("full Sk=96", 1, 32, 96, 4, 4, 64, 64, False, 0),
    ("MQA 200", 1, 200, 200, 8, 1, 64, 64, True, 0),
)


def check_flash(gen: torch.Generator) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, sq, sk, h, kv, d, dv, causal, window in FLASH_CASES:
            q = rand(gen, (b, sq, h, d), dtype)
            k = rand(gen, (b, sk, kv, d), dtype)
            v = rand(gen, (b, sk, kv, dv), dtype)
            got = fa_mod.flash_attention(q, k, v, causal=causal,
                                         window=window)
            torch.cuda.synchronize()
            exp = ref.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)
            err = assert_close(got, exp, dtype, f"flash {name} {dtype}")
            log(f"  flash    {name:13s} {str(dtype):14s} "
                f"max_abs_err={err:.3e}  ok")


def kernel_record(name, source, replaces, kernel_fn, plain_fn, library_fn,
                  nbytes, nops, dtype) -> dict:
    got, exp = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = assert_close(got, exp, dtype, f"{name} timed shape")
    lib_err = float((library_fn().float() - exp.float()).abs().max())
    log(f"  {name}: library call differs from the plain version by "
        f"{lib_err:.3e} (a yardstick of time only; not asserted)")
    bytes_ms = nbytes / H100_HBM_BW * 1e3
    ops_ms = nops / PEAK[dtype] * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": time_ms(library_fn),
    }


def time_kernels(gen: torch.Generator) -> list:
    """Kernel records at the served shapes: batch SERVE_BATCH of SEQ
    tokens through llama3.2-1b (rows = 256, D = 2048; flash B = 8,
    32 q heads over 8 kv heads, head_dim 64), f32."""
    dtype = torch.float32
    rows, d = SERVE_BATCH * SEQ, 2048
    x, g = rand(gen, (rows, d), dtype), rand(gen, (d,), dtype)
    esz = x.element_size()
    records = [kernel_record(
        "rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:28",
        lambda: rms_mod.rmsnorm(x, g), lambda: ref.rmsnorm_ref(x, g),
        lambda: F.rms_norm(x, (d,), g, 1e-6),
        nbytes=(2 * rows * d + d) * esz, nops=4 * rows * d, dtype=dtype)]
    xs, gs = rand(gen, (rows, 768), dtype), rand(gen, (768,), dtype)
    log(f"  rmsnorm at the xlstm shape rows={rows} D=768: kernel "
        f"{time_ms(lambda: rms_mod.rmsnorm(xs, gs)):.4f} ms, plain "
        f"{time_ms(lambda: ref.rmsnorm_ref(xs, gs)):.4f} ms, F.rms_norm "
        f"{time_ms(lambda: F.rms_norm(xs, (768,), gs, 1e-6)):.4f} ms")

    b, s, h, kv, hd = SERVE_BATCH, SEQ, 32, 8, 64
    q = rand(gen, (b, s, h, hd), dtype)
    k = rand(gen, (b, s, kv, hd), dtype)
    v = rand(gen, (b, s, kv, hd), dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pairs = int(ref.causal_mask_ref(s, s).sum())      # keys this mask keeps
    records.append(kernel_record(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:78",
        lambda: fa_mod.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2),
        nbytes=(q.numel() + k.numel() + v.numel() + q.numel()) * esz,
        nops=b * h * pairs * 2 * (hd + hd), dtype=dtype))
    for r in records:
        log(f"  {r['name']:15s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return records


# ---------------------------------------------------------------- phase 3

def check_forward_against_cpu() -> None:
    """The port's forward through the kernels on the card agrees with its
    plain path on the CPU, same parameters, smoke configs."""
    for arch, s in (("llama3.2-1b", 32), ("llama3.2-1b-sw", 96),
                    ("xlstm-125m", 32)):
        cfg = get_smoke(arch)
        cpu_model = build_model(cfg, "cpu")
        params = cpu_model.init(torch.Generator().manual_seed(0))
        gpu_model = build_model(cfg, "cuda")
        gpu_params = _tree_to(params, "cuda")
        tok = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, s), dtype=np.int64))
        with torch.inference_mode():
            exp, _ = cpu_model.forward(params, {"tokens": tok})
            got, _ = gpu_model.forward(gpu_params,
                                       {"tokens": tok.to("cuda")})
        got = got.cpu()
        err = float((got - exp).abs().max())
        torch.testing.assert_close(got, exp, atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"{arch} forward: {m}")
        log(f"  {arch:15s} smoke forward cuda vs cpu: max_abs_err="
            f"{err:.3e} (tol 1e-4)  ok")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


def build_and_profile():
    stages, store = {}, ProfileStore()
    for arch in STAGES:
        t0 = time.perf_counter()
        st = make_stage(arch, "cuda", full=True, seed=0)
        n_params = sum(t.numel() for t in _leaves(st.params))
        with torch.inference_mode():
            logits, _ = st.model.forward(st.params, {"tokens": torch.ones(
                (2, SEQ), dtype=torch.int32, device=st.model.device)})
        if logits.shape != (2, SEQ, st.cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{arch}: bad full-width logits "
                               f"{tuple(logits.shape)}")
        st.warmup(max(PROFILE_BATCHES))
        store.add(profile_model_measured(arch, st.profile_fn, "h100-1",
                                         batch_sizes=PROFILE_BATCHES))
        stages[arch] = st
        log(f"  {arch}: {st.cfg.num_layers}L d_model={st.cfg.d_model} "
            f"vocab={st.cfg.vocab_size} params={n_params} "
            f"({time.perf_counter() - t0:.1f} s to build, warm, profile)")
    log("  batch  " + "  ".join(f"{a + ' ms':>16s} {'qps':>8s}"
                                for a in STAGES))
    for bsz in PROFILE_BATCHES:
        cells = []
        for arch in STAGES:
            lat = store.get(arch).batch_latency("h100-1", bsz)
            cells.append(f"{lat * 1e3:16.3f} {bsz / lat:8.1f}")
        log(f"  {bsz:5d}  " + "  ".join(cells))
    return stages, store


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- phase 4

def serve(stages) -> dict:
    pipe = linear_pipeline("cascade", list(STAGES),
                           {a: ["h100-1"] for a in STAGES})
    config = PipelineConfig({s: StageConfig("h100-1", SERVE_BATCH, 1)
                             for s in pipe.stages})
    ex = PipelineExecutor(pipe, config,
                          {a: stages[a].run_batch for a in STAGES})
    arrivals = gamma_trace(SERVE_QPS, 1.0, SERVE_S, seed=1)
    vocab_a = stages[STAGES[0]].cfg.vocab_size
    vocab_b = stages[STAGES[1]].cfg.vocab_size

    def payload(i: int) -> np.ndarray:
        return np.random.default_rng(1000 + i).integers(
            0, vocab_a, SEQ, dtype=np.int32)

    try:
        rms_mod.counter.reset()
        fa_mod.counter.reset()
        lat = ex.serve_trace(arrivals, payload)
        launches = {"rmsnorm": rms_mod.counter.count,
                    "flash_attention": fa_mod.counter.count}
        outs = ex.outputs()
        sizes = ex.batch_sizes()
    finally:
        if not ex.shutdown():
            raise RuntimeError("executor workers did not stop")
    if not np.isfinite(lat).all():
        raise RuntimeError(f"{int((~np.isfinite(lat)).sum())} of "
                           f"{lat.size} requests unanswered")
    for i, out in enumerate(outs):
        p = payload(i)
        if not (isinstance(out, np.ndarray) and out.shape == (SEQ,)
                and out.dtype == np.int32):
            raise RuntimeError(f"request {i}: bad answer {out!r}")
        # two stages: the window shifted by two, each stage's argmax
        # appended, each inside its model's vocabulary
        if not (np.array_equal(out[:SEQ - 2], p[2:])
                and 0 <= out[-2] < vocab_a and 0 <= out[-1] < vocab_b):
            raise RuntimeError(f"request {i}: answer is not the cascade "
                               f"of shifted windows: {out}")
    n_batches = {a: int(sizes[f"s{i}_{a}"].size)
                 for i, a in enumerate(STAGES)}
    per_fwd = {a: launches_per_forward(stages[a].cfg) for a in STAGES}
    expect = {name: sum(per_fwd[a][name] * n_batches[a] for a in STAGES)
              for name in ("rmsnorm", "flash_attention")}
    if launches != expect:
        raise RuntimeError(f"kernel launches during serving {launches} != "
                           f"{expect} expected from {n_batches} batches")
    if max(int(v.max()) for v in sizes.values()) > SERVE_BATCH:
        raise RuntimeError(f"a batch exceeded {SERVE_BATCH}: {sizes}")
    mean_batch = {s: round(float(v.mean()), 3) for s, v in sizes.items()}
    log(f"  served {lat.size} requests at {SERVE_QPS:g} qps for "
        f"{SERVE_S:g} s: p50 {np.percentile(lat, 50) * 1e3:.2f} ms  p99 "
        f"{np.percentile(lat, 99) * 1e3:.2f} ms  miss(SLO {SLO_S * 1e3:g} "
        f"ms) {float((lat > SLO_S).mean()):.4f}")
    log(f"  batches per stage {n_batches}, mean batch size {mean_batch}")
    log(f"  kernel launches during serving {launches} (expected {expect})")
    return launches


# ---------------------------------------------------------------- phase 5

def trace(stages, store) -> None:
    """Device time of one batch of SERVE_BATCH per stage, summed over the
    CUDA kernels torch.profiler records, against the stage's profiled
    batch latency (taken without the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    for arch in STAGES:
        st = stages[arch]
        st.profile_fn(SERVE_BATCH)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st.profile_fn(SERVE_BATCH)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            log(f"  {arch}: device time not measured (the profiler "
                f"recorded no CUDA kernel)")
            continue
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        wall_ms = store.get(arch).batch_latency("h100-1", SERVE_BATCH) * 1e3
        log(f"  {arch} b={SERVE_BATCH}: {sum(e.count for e in kernels)} "
            f"kernel launches, device busy {busy_ms:.3f} ms of a "
            f"{wall_ms:.3f} ms batch ({busy_ms / wall_ms:.1%}; idle "
            f"{1 - busy_ms / wall_ms:.1%})")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    {e.self_device_time_total / 1e3:8.3f} ms  "
                f"x{e.count:<5d} {e.key[:90]}")
        for name in ("rmsnorm_kernel", "flash_fwd_kernel"):
            ev = [e for e in kernels if name in e.key]
            if ev:
                per = sum(e.self_device_time_total for e in ev) / \
                    sum(e.count for e in ev)
                log(f"    {name}: {per:.2f} us of device time per launch")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU; this script runs the "
              "port on the card", file=sys.stderr)
        return 2
    # the plain versions and the model's matmuls run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    log("[1] build kernels")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"  {lib_path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())

    log("[2] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_rmsnorm(gen)
    check_flash(gen)
    records = time_kernels(gen)

    log("[3] forward against the CPU path; full-width stages, profile")
    check_forward_against_cpu()
    stages, store = build_and_profile()

    log("[4] serve the cascade")
    launches = serve(stages)
    log("[5] trace one batch per stage")
    trace(stages, store)
    for r in records:
        r["launches"] = launches[r["name"]]
    if not all(r["launches"] > 0 for r in records):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
