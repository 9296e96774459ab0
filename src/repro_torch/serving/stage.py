"""The served cascade's stage: one model scoring token windows.

The counterpart of ``make_stage`` in ``examples/serve_real_models.py``:
a stage scores a batch of ``(SEQ,)`` int32 token windows with
``Model.forward`` and answers each with the window shifted by one, the
argmax of the last position appended, so the next stage of the cascade
receives the same shape.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.models import Model, build_model
from repro_torch.models.config import ArchConfig

SEQ = 32


class ServedStage(NamedTuple):
    cfg: ArchConfig
    model: Model
    params: Dict[str, Any]
    run_batch: Callable[[List[Any]], List[np.ndarray]]
    profile_fn: Callable[[int], None]
    warmup: Callable[..., None]


def _bucket(n: int) -> int:
    """Next power of two >= n: a fixed set of batch shapes."""
    b = 1
    while b < n:
        b *= 2
    return b


def make_stage(arch_id: str,
               device: Optional[Union[str, torch.device]] = None,
               full: bool = True, seed: int = 0) -> ServedStage:
    """Build ``arch_id`` at its published widths (``full=False``: the
    smoke variant) with seeded random parameters on ``device`` (default
    ``cuda``) and return its batch scoring functions."""
    cfg = get_arch(arch_id) if full else get_smoke(arch_id)
    model = build_model(cfg, device)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)

    @torch.inference_mode()
    def score(tokens: torch.Tensor) -> torch.Tensor:
        logits, _ = model.forward(params, {"tokens": tokens})
        nxt = logits[:, -1].argmax(dim=-1).to(tokens.dtype)
        return torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)

    def run_batch(payloads: List[Any]) -> List[np.ndarray]:
        # pad to a power-of-two bucket: the same few shapes every time
        n = len(payloads)
        tokens = np.zeros((_bucket(n), SEQ), dtype=np.int32)
        tokens[:n] = np.stack([np.asarray(p, dtype=np.int32)
                               for p in payloads])
        out = score(torch.from_numpy(tokens).to(dev)).cpu().numpy()
        return list(out[:n])

    def profile_fn(b: int) -> None:
        score(torch.ones((b, SEQ), dtype=torch.int32, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def warmup(max_batch: int = 16) -> None:
        b = 1
        while b <= max_batch:
            profile_fn(b)
            b *= 2

    return ServedStage(cfg, model, params, run_batch, profile_fn, warmup)
