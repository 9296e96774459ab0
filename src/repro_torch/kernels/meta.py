"""The kernels' ``meta`` branch: shapes and FLOPs without a launch.

Inside :func:`shapes_only` a kernel wrapper given ``meta`` tensors (the
dry-run's; no storage) returns outputs of the kernel's true shapes and
dtypes, flash attention's out and logsumexp and never an S x S score
tensor, and adds the work its kernel would do to :func:`flops`. Outside
that context a ``meta`` tensor still raises "unsupported device" in
every wrapper: the branch is entered only by a caller that names it,
never chosen for one.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np

_state = threading.local()


@contextlib.contextmanager
def shapes_only():
    """Let the wrappers take ``meta`` tensors; the counts restart at 0."""
    prev = getattr(_state, "flops", None), getattr(_state, "bytes", 0.0)
    _state.flops, _state.bytes = 0.0, 0.0
    try:
        yield
    finally:
        _state.flops, _state.bytes = prev


def enabled() -> bool:
    return getattr(_state, "flops", None) is not None


def add(flops: float, *tensors, nbytes: float = None) -> None:
    """Count a kernel call: its FLOPs, and its inputs' and outputs'
    bytes (each read or written once), or ``nbytes`` where a branch
    counts the bytes of a loop of operations itself."""
    _state.flops += float(flops)
    _state.bytes += float(nbytes) if nbytes is not None else float(
        sum(t.numel() * t.element_size() for t in tensors))


def flops() -> float:
    """The kernels' FLOPs since :func:`shapes_only` was entered."""
    return float(getattr(_state, "flops", None) or 0.0)


def nbytes() -> float:
    """The kernels' bytes since :func:`shapes_only` was entered."""
    return float(getattr(_state, "bytes", None) or 0.0)


def takes(t) -> bool:
    """Whether a wrapper given ``t`` runs its meta branch."""
    return t.device.type == "meta" and enabled()


def attention_pairs(b: int, sq: int, sk: int, h: int, causal: bool,
                    window: int) -> int:
    """The (query, key) pairs a flash call keeps, over batch and heads:
    the causal diagonal offset by ``sk - sq``, the window counting back
    from it."""
    if not causal:
        return b * h * sq * sk
    i = np.arange(sq, dtype=np.int64)
    hi = np.clip(i + (sk - sq) + 1, 0, sk)
    lo = np.maximum(0, hi - window) if window > 0 else 0
    return b * h * int((hi - lo).sum())
