"""Where the selective scan's backward kernel spends its time, by phase,
on one card.

Builds a copy of ``csrc/mamba_scan_bwd.cu`` with ``clock64()`` stamps
taken by thread 0 of two CTAs at every phase boundary (the barriers, the
B/C spread, the copies' issue, the replay, the walk, the dB/dC sums),
runs it at the hybrid's training chunk (B 1, L 256, D 16384, N 16, f32),
and prints the SM clocks each phase took, summed over the segments::

    PYTHONPATH=src python tools/scan_bwd_phases.py

The stamps are written over the copy's dh0, which is then not a
gradient; the copy is built beside the port's library and never loaded
by it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build

sys.path.insert(0, str(Path(__file__).resolve().parent))
import scan_bwd_vs_parent as tool  # noqa: E402

CTAS = (0, 77)          # the CTAs whose thread 0 stamps
STAMPS = 512            # room for them in shared memory
# (anchor in the kernel, what goes before it)
MARKS = (
    ("  issue(0);\n", "  STAMP();\n"),
    ("    __syncthreads();   // job q has landed; every thread is done"
     " with q - 1\n", "    STAMP();\n"),
    ("    if (q + 1 < jobs) issue(q + 1);", "    STAMP();\n"),
    ("    __syncthreads();   // B and C spread\n", "    STAMP();\n"),
    ("    // ddt on the group's lower half, dx on its upper: one lane of"
     " each", "    STAMP();\n"),
    ("    __syncthreads();   // every warp's sums of the segment are in\n",
     "    STAMP();\n"),
)
AFTER = (
    ("    __syncthreads();   // job q has landed; every thread is done"
     " with q - 1\n", "    STAMP();\n"),
    ("    __syncthreads();   // B and C spread\n", "    STAMP();\n"),
    ("    __syncthreads();   // every warp's sums of the segment are in\n",
     "    STAMP();\n"),
)
PASS1 = ("top barrier", "spread", "issue", "spread barrier", "pass 1")
PASS2 = ("top barrier", "spread", "issue", "spread barrier", "replay",
         "walk", "sums barrier", "sums, wait")


def instrumented(src: str) -> str:
    """The kernel with the stamps in, written out over dh0 at its end."""
    head = ("  __shared__ long long stamps[%d]; int n_stamps = 0;\n"
            "#define STAMP() do { if (tid == 0 && n_stamps < %d) "
            "stamps[n_stamps++] = clock64(); } while (0)\n" %
            (STAMPS, STAMPS))
    for anchor, before in MARKS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, before + anchor)
    for anchor, after in AFTER:
        src = src.replace(anchor, anchor + after)
    src = src.replace("  STAMP();\n  issue(0);\n",
                      head + "  STAMP();\n  issue(0);\n")
    end = "  cp_async_wait_all();\n\n  if (live) {"
    assert src.count(end) == 1
    src = src.replace(end, "  STAMP();\n" + end)
    tail = ("        make_float4(da[0], da[1], da[2], da[3]);\n  }\n")
    assert src.count(tail) == 1
    ctas = " || ".join(f"blockIdx.x == {c}" for c in CTAS)
    return src.replace(tail, tail + (
        "  __syncthreads();\n"
        f"  if (tid == 0 && blockIdx.y == 0 && ({ctas})) {{\n"
        "    long long* o = reinterpret_cast<long long*>(dh0) +\n"
        "                   blockIdx.x * (C * N / 2);\n"
        "    o[0] = n_stamps;\n"
        "    for (int i = 0; i < n_stamps; ++i) o[1 + i] = stamps[i];\n"
        "  }\n"))


def phases(st: list, segs: int) -> dict:
    """SM clocks by phase, summed over the jobs, from one CTA's stamps:
    the first, then per job four stamps and pass 1's end, or seven
    after which the next job's first stamp closes the sums."""
    out: dict = {}
    i = 1
    for q in range(2 * segs - 1):
        names = PASS1 if q < segs - 1 else PASS2
        for k, name in enumerate(names):
            out[name] = out.get(name, 0) + st[i + k + 1] - st[i + k]
        i += len(names)
    out["total"] = st[-1] - st[0]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run on the card only")
        return 1
    src = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "scan_bwd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    copy = out_dir / "mamba_scan_bwd_stamped.cu"
    copy.write_text(instrumented(src))
    dll, _ = tool.build_parent(copy, out_dir)
    b, length, d, n = 1, 256, 16384, 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = tool.inputs(gen, b, length, d, n, torch.float32)
    for _ in range(3):
        out = tool.parent_call(dll, *args)
    torch.cuda.synchronize()
    raw = out[5].view(-1).view(torch.int64).cpu().tolist()
    segs = -(-length // 16)
    for cta in CTAS:
        base = cta * 64 * n // 2
        st = raw[base + 1:base + 1 + raw[base]]
        print(f"CTA {cta}: {len(st)} stamps; SM clocks by phase "
              f"{phases(st, segs)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
