"""Time the flash attention forward kernel against an earlier version of
it, on one card, in one process, on the same inputs, and hold both
f32 forwards against the same attention in f64.

The earlier version is a copy of ``csrc/flash_attention.cu`` and the
``mma.cuh`` it includes, from another commit, in a directory of their
own (the other headers come from the current tree), built here into
a second shared library with the same C entry
(``flash_attention_fwd``)::

    mkdir -p build/parent
    for f in flash_attention.cu mma.cuh; do
        git show HEAD~1:src/repro_torch/kernels/csrc/$f > build/parent/$f
    done
    PYTHONPATH=src python tools/flash_fwd_vs_parent.py --parent build/parent

It prints chip_smoke's phase-2 f64 check (``flash_f64_errors``: each
row's max |O - O_f64| over its largest |O|) for both versions, then for
each shape and dtype both versions' outputs against the plain version
and their times with CUDA events in turns (earlier, current, current,
earlier, ...). It writes the readings as JSON (``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402

# (label, B, Sq, Sk, H, KV, D, Dv, causal): the served shape of phase 2's
# record, the llama and MLA prefills, whisper's cross-attention and
# pixtral's 4096
SHAPES = (("served", chip_smoke.SERVE_BATCH, chip_smoke.SEQ,
           chip_smoke.SEQ, 32, 8, 64, 64, True),
          ("llama prefill", 8, 512, 512, 32, 8, 64, 64, True),
          ("MLA prefill", 8, 512, 512, 128, 128, 192, 128, True),
          ("whisper cross", 2, 2048, 1500, 12, 12, 64, 64, False),
          ("pixtral 4096", 1, 4096, 4096, 32, 8, 128, 128, True))
ROUNDS = 3            # of (earlier, current, current, earlier) timings


def log(msg: str) -> None:
    print(msg, flush=True)


def build_parent(src_dir: Path, out_dir: Path):
    """The earlier ``flash_attention.cu`` built alone, its own
    ``mma.cuh`` beside it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libflash_fwd_parent.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir),
           "-I", str(_build.CSRC), "-shared", "-o", str(lib),
           str(src_dir / "flash_attention.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    fn = dll.flash_attention_fwd
    fn.argtypes, fn.restype = _build.SIGNATURES["flash_attention_fwd"]
    return fn


def parent_call(fn, q, k, v, causal):
    """The earlier kernel, called as the current wrapper calls it."""
    dtype = fa_mod._check(q, k, v)
    b, sq, h, d = q.shape
    sk, kvh, dv = v.shape[1], v.shape[2], v.shape[3]
    out = q.new_empty((b, sq, h, dv))
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), None, dtype, b, sq, sk, h, kvh, d, dv,
                    int(causal), 0, 1.0 / math.sqrt(d),
                    _build.stream(q.get_device())), "parent flash forward")
    return out


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a directory with an earlier flash_attention.cu "
                         "and its mma.cuh")
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/flash_fwd_vs_parent.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device: the kernels run on the card only")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    _build.load()
    parent = build_parent(args.parent,
                          _build.BUILD_DIR.parent / "flash_fwd_parent")
    readings = {"card": card, "f64": {}, "times": []}
    for label, fn in (("earlier", lambda q, k, v, c: parent_call(
            parent, q, k, v, c)), ("current", None)):
        rows = chip_smoke.flash_f64_errors(fn)
        readings["f64"][label] = rows
        for name, row, whole in rows:
            log(f"  {label:8s} {name:13s} f32 against f64: worst row "
                f"{row:.3e} of its largest |O|, whole output {whole:.3e} "
                f"(phase 2's bar {chip_smoke.FLASH_F64_REL:g})")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, sq, sk, h, kv, d, dv, causal in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = chip_smoke.rand(gen, (b, sq, h, d), dtype)
            k = chip_smoke.rand(gen, (b, sk, kv, d), dtype)
            v = chip_smoke.rand(gen, (b, sk, kv, dv), dtype)
            exp = ref.flash_attention_ref(q, k, v, causal=causal).float()
            fns = (lambda: parent_call(parent, q, k, v, causal),
                   lambda: fa_mod.flash_attention(q, k, v, causal=causal))
            errs = [float((f().float() - exp).abs().max()) for f in fns]
            iters = max(5, min(200, int(2e10 / (b * sq * sk * h * d))))
            best = [float("inf")] * 2
            for r in range(ROUNDS):
                for i in ((0, 1, 1, 0) if r % 2 == 0 else (1, 0, 0, 1)):
                    best[i] = min(best[i], time_ms(fns[i], iters))
            reading = {"shape": label, "B": b, "Sq": sq, "Sk": sk, "H": h,
                       "KV": kv, "D": d, "Dv": dv, "causal": causal,
                       "dtype": str(dtype)[6:], "earlier_ms": best[0],
                       "current_ms": best[1], "earlier_err": errs[0],
                       "current_err": errs[1]}
            readings["times"].append(reading)
            log(f"  {label:13s} {reading['dtype']:8s} earlier "
                f"{best[0]:.4f} ms, current {best[1]:.4f} ms "
                f"({best[1] / best[0]:.3f}x); max abs err against the "
                f"plain version {errs[0]:.3e} / {errs[1]:.3e}")
            del q, k, v, exp
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
