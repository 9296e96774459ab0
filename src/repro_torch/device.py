"""Device resolution and the dtype-name map.

Entry points run on the GPU unless the caller asks for the CPU. There is
no silent fallback: asking for CUDA on a host without a GPU raises. The
``meta`` device (shapes and dtypes, no storage: the dry-run's) is taken
only when the caller names it; it is never chosen for the caller.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent;
    ``"meta"`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch sees no GPU; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Map an ``ArchConfig`` dtype string to a torch dtype."""
    try:
        return DTYPES[name]
    except KeyError:
        raise KeyError(f"unknown dtype {name!r}; have {sorted(DTYPES)}") \
            from None
