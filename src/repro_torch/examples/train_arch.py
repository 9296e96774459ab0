"""Train any assigned architecture (reduced variant) on synthetic data.

The port's copy of ``examples/train_arch.py``: config -> model -> data
pipeline -> AdamW -> checkpoint save/restore, with the reference's
arguments, constants and printed lines. It runs on the card (the
kernels carry the gradients: flash attention's, RMSNorm's and the
selective scan's backward, so the hybrid trains too) unless given
``--device cpu``. ~20M-parameter reduced variants train a few hundred
steps in minutes; loss decreases on the learnable bigram corpus.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_arch \\
          --arch llama3.2-1b --steps 200
"""

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.models import build_model
from repro_torch.train import checkpoint
from repro_torch.train.data import batches
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer
from repro_torch.train.tree import leaves


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Train, check that the loss fell, save and restore the checkpoint;
    returns the losses. Raises SystemExit if the loss did not fall or the
    restored parameters differ."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="artifacts/example_ckpt_torch.npz")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    model = build_model(cfg, args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    n = sum(p.numel() for p in leaves(params))
    print(f"arch={args.arch} (reduced)  params={n/1e6:.1f}M  "
          f"layers={cfg.num_layers}  d_model={cfg.d_model}")

    trainer = Trainer(model, AdamW(lr=args.lr), log_every=20)
    data = batches(cfg, args.batch, args.seq, seed=0, steps=args.steps)
    params, opt_state, losses = trainer.fit(params, data, args.steps)

    print(f"\nloss: first10={np.mean(losses[:10]):.4f}  "
          f"last10={np.mean(losses[-10:]):.4f}")
    if not np.mean(losses[-10:]) < np.mean(losses[:10]):
        raise SystemExit("did not learn")

    os.makedirs(os.path.dirname(args.ckpt) or ".", exist_ok=True)
    checkpoint.save(args.ckpt, params)
    restored = checkpoint.restore(args.ckpt, params)
    if not all(torch.allclose(a.float(), b.float())
               for a, b in zip(leaves(params), leaves(restored))):
        raise SystemExit(f"checkpoint round-trip changed a leaf: {args.ckpt}")
    print(f"checkpoint round-trip OK -> {args.ckpt}")
    return losses


if __name__ == "__main__":
    main()
