"""Synthetic data pipeline: deterministic, seekable token streams.

A copy of the reference's ``repro/train/data.py`` (numpy only):
documents drawn from a fixed random bigram table, so next-token
prediction has learnable structure, plus the modality stubs (frame/patch features) of the
enc-dec and vlm families. It yields the reference's numpy arrays, equal
with ``==`` for the same config, sizes and seed; ``Trainer.fit`` moves
them to the model's device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ArchConfig

AUDIO_FEAT_DIM = 128
IMAGE_FEAT_DIM = 1024


class SyntheticCorpus:
    """Deterministic pseudo-corpus: each document is sampled from a fixed
    random bigram table, so next-token prediction has learnable
    structure."""

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 8):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self.branch = branch
        v_eff = min(vocab_size, 4096)
        self._succ = rng.integers(0, v_eff, size=(v_eff, branch))
        self._v_eff = v_eff

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int64)
        tok = int(rng.integers(0, self._v_eff))
        for i in range(length):
            out[i] = tok
            tok = int(self._succ[tok, rng.integers(0, self.branch)])
        return out


def batches(cfg: ArchConfig, batch_size: int, seq_len: int,
            seed: int = 0, steps: Optional[int] = None
            ) -> Iterator[Dict[str, np.ndarray]]:
    corpus = SyntheticCorpus(cfg.vocab_size, seed)
    rng = np.random.default_rng(seed + 1)
    i = 0
    while steps is None or i < steps:
        toks = np.stack([corpus.sample(rng, seq_len)
                         for _ in range(batch_size)])
        batch: Dict[str, np.ndarray] = {"tokens": toks}
        if cfg.num_image_tokens:
            batch["image_feats"] = rng.normal(
                size=(batch_size, cfg.num_image_tokens, IMAGE_FEAT_DIM)
            ).astype(np.float32)
        if cfg.is_encoder_decoder:
            batch["frames"] = rng.normal(
                size=(batch_size, cfg.encoder_max_frames, AUDIO_FEAT_DIM)
            ).astype(np.float32)
        yield batch
        i += 1
