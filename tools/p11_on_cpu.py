"""Phase 11's comparison of a sharded model against one card, run on the
CPU over gloo: ``chip_smoke._p11_against_one_card`` on four ranks, each
a process, with the CUDA calls it makes for timing and memory stubbed
and the kernels' plain versions in place of the kernels. It prints rank
0's readings: max |dlogit| / max |logit| of the forward and of the
prefill and greedy steps on the (1, 4) and (2, 2) meshes, and the greedy
tokens that agree::

    PYTHONPATH=src python tools/p11_on_cpu.py xlstm-125m 8 512 1024
    PYTHONPATH=src python tools/p11_on_cpu.py whisper-small 8 64 448
    PYTHONPATH=src python tools/p11_on_cpu.py --smoke pixtral-12b 4 8 48

The arguments are the architecture, the prompt's rows and tokens, and
the cache's slots. At published width each rank holds the whole model
beside its shards (xlstm-125m ~1 min, whisper-small ~5 min on 8 cores).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4


def _rank(rank: int, store: str, args) -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as c
    from repro_torch.configs import get_arch, get_smoke

    c._p11_dev = lambda r: torch.device("cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.set_num_threads(max(1, (os.cpu_count() or WORLD) // WORLD))
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    cfg = (get_smoke if args.smoke else get_arch)(args.arch)
    out = c._p11_against_one_card(rank, cfg, c.PAR_MESHES,
                                  batch=args.batch,
                                  prompt_len=args.prompt, smax=args.smax)
    if rank == 0:
        keep = ("forward_rel", "steps_rel", "tokens_equal", "tokens")
        print(json.dumps({"arch": cfg.name,
                          "meshes": {k: {x: m[x] for x in keep}
                                     for k, m in out["meshes"].items()},
                          "s": out["s"]}, indent=1))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("batch", type=int)
    ap.add_argument("prompt", type=int)
    ap.add_argument("smax", type=int)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's smoke config")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(os.path.join(tmp, "store"), args),
                 nprocs=WORLD)


if __name__ == "__main__":
    main()
