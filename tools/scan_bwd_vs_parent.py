"""Time the selective scan's backward kernel against an earlier version of
it, on one card, in one process, on the same inputs.

The earlier version is a copy of ``csrc/mamba_scan_bwd.cu`` from another
commit, built here on its own into a second shared library with the same
C entries (``mamba_scan_bwd``, ``mamba_scan_bwd_workspace``)::

    mkdir -p build/parent
    git show HEAD~1:src/repro_torch/kernels/csrc/mamba_scan_bwd.cu \\
        > build/parent/mamba_scan_bwd.cu
    PYTHONPATH=src python tools/scan_bwd_vs_parent.py \\
        --parent build/parent/mamba_scan_bwd.cu

For each shape and dtype it checks both kernels against the plain
reverse recurrence (``ref.mamba_scan_bwd_ref``), times them with CUDA
events in turns (earlier, current, current, earlier, ...), and reads the
device time of each launched kernel from ``torch.profiler``. It prints
one line a reading and writes them all as JSON (``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, mamba_scan as ms_mod, ref

# (label, B, L, D, N): the hybrid's training chunk, and eight of its rows
SHAPES = (("training chunk", 1, 256, 16384, 16),
          ("B 8", 8, 256, 16384, 16))
KERNEL_RE = re.compile(r"(mamba_scan_bwd\w*)")
ROUNDS = 3            # of (earlier, current, current, earlier) timings


def log(msg: str) -> None:
    print(msg, flush=True)


def build_parent(src: Path, out_dir: Path) -> tuple:
    """(the library, ptxas's report) of ``src`` built alone."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libscan_bwd_parent.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-shared", "-o", str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    for name in ("mamba_scan_bwd", "mamba_scan_bwd_workspace"):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name]
    return dll, done.stderr


def resources(log_text: str) -> list:
    """ptxas's registers / shared memory / spill lines of the scan
    backward's kernels, one string each."""
    lines, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "mamba_scan_bwd" in name and (
                "registers" in line or "spill" in line):
            lines.append(f"{name[:60]}: {line.split('ptxas info    :')[-1]}"
                         .strip())
    return lines


def parent_call(dll, dt, x, b, c, a, h0, dy, dh):
    """The earlier kernel, allocated as its wrapper allocated it."""
    bsz, length, d = dt.shape
    n = a.shape[1]
    floats = ctypes.c_longlong(0)
    _build.check(dll.mamba_scan_bwd_workspace(bsz, length, d, n,
                                              ctypes.byref(floats)),
                 "parent workspace")
    work = torch.empty(floats.value, dtype=torch.float32, device=dt.device)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da, dh0 = torch.empty_like(a), torch.empty_like(h0)
    rc = dll.mamba_scan_bwd(
        dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), h0.data_ptr(), dy.data_ptr(), dh.data_ptr(),
        ddt.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), dh0.data_ptr(), work.data_ptr(),
        ms_mod.KERNEL_DTYPES[dt.dtype], bsz, length, d, n,
        _build.stream(dt.get_device()))
    _build.check(rc, "parent mamba_scan_bwd")
    return ddt, dx, db, dc, da, dh0


def inputs(gen, b, length, d, n, dtype) -> list:
    """dt, x, b, c, a, h0, dy, dh as chip_smoke.scan_bwd_inputs makes
    them: drawn as the reference's kernel sweep draws the forward's."""
    def rand(shape, dt_=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dt_)
    return [torch.nn.functional.softplus(rand((b, length, d)) * 0.3
                                         ).to(dtype),
            rand((b, length, d), dtype),
            (rand((b, length, n)) * 0.5).to(dtype),
            (rand((b, length, n)) * 0.5).to(dtype),
            -torch.exp(rand((d, n)) * 0.3),
            rand((b, d, n)) * 0.1,
            rand((b, length, d), dtype),
            rand((b, d, n))]


def rel_errors(got, exp) -> list:
    return [float((g.float() - e.float()).abs().max())
            / max(float(e.float().abs().max()), 1e-30)
            for g, e in zip(got, exp)]


def time_ms(fn, iters: int) -> float:
    for _ in range(5):
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


def device_us(fn, calls: int = 10) -> dict:
    """Device us a call of each scan-backward kernel, torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = KERNEL_RE.search(e.key)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + \
                e.self_device_time_total / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an earlier mamba_scan_bwd.cu")
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/scan_bwd_vs_parent.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device: the kernels run on the card only")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    _build.load()
    for line in resources(_build.build_log):
        log(f"  current  {line}")
    dll, parent_log = build_parent(args.parent,
                                   _build.BUILD_DIR.parent / "scan_bwd_parent")
    for line in resources(parent_log):
        log(f"  earlier  {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings = []
    for label, b, length, d, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            if label != SHAPES[0][0] and dtype != torch.float32:
                continue
            args_ = inputs(gen, b, length, d, n, dtype)
            exp = ref.mamba_scan_bwd_ref(*args_)
            new = ms_mod._launch_bwd(*args_)
            old = parent_call(dll, *args_)
            again = ms_mod._launch_bwd(*args_)
            torch.cuda.synchronize()
            fns = (lambda: parent_call(dll, *args_),
                   lambda: ms_mod._launch_bwd(*args_))
            best = [float("inf")] * 2
            for r in range(ROUNDS):
                for i in ((0, 1, 1, 0) if r % 2 == 0 else (1, 0, 0, 1)):
                    best[i] = min(best[i], time_ms(fns[i], 20))
            grid, per_sm = ms_mod.bwd_launch_plan(dtype, b, length, d, n)
            reading = {
                "shape": label, "B": b, "L": length, "D": d, "N": n,
                "dtype": str(dtype)[6:], "card": card,
                "earlier_ms": best[0], "current_ms": best[1],
                "speedup": best[0] / best[1],
                "current_device_us": device_us(fns[1]),
                "earlier_device_us": device_us(fns[0]),
                "current_rel_err": rel_errors(new, exp),
                "earlier_rel_err": rel_errors(old, exp),
                "bit_equal_second_call": all(
                    torch.equal(p, q) for p, q in zip(new, again)),
                "grid": grid, "ctas_per_sm": per_sm,
                "warps_per_sm": per_sm * ms_mod.BWD_THREADS[n] // 32,
            }
            readings.append(reading)
            log(f"{label} B={b} L={length} D={d} N={n} {reading['dtype']}: "
                f"earlier {best[0]:.4f} ms, current {best[1]:.4f} ms "
                f"({reading['speedup']:.2f}x); device us current "
                f"{reading['current_device_us']}, earlier "
                f"{reading['earlier_device_us']}; relative errors current "
                f"{max(reading['current_rel_err']):.2e}, earlier "
                f"{max(reading['earlier_rel_err']):.2e}; second call "
                f"bit-equal {reading['bit_equal_second_call']}; "
                f"{per_sm} CTAs ({reading['warps_per_sm']} warps) an SM, "
                f"grid {grid}")
            del args_, exp, new, old, again
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
