"""Load the reference's parameter and cache trees into the port.

The JAX package's ``Model.init`` returns a nested dict/tuple tree of
arrays; handed over as numpy arrays (``np.asarray`` of each leaf) it
becomes the port's tree with the same keys and nesting, including the
stacked leading ``repeat`` axis of every segment. A cache state from
``Model.prefill`` / ``decode_step`` converts the same way, its ``None``
(no cross-attention cache) kept as ``None``. bfloat16 arrays (numpy's
extension type of that name) are carried bit for bit.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")      # an owned, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _convert(tree, device: torch.device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(v, device) for v in tree)
    return _leaf(tree, device)


def params_from_numpy(tree, device: Union[str, torch.device, None] = None):
    """Same-structure tree of tensors on ``device`` (default ``cuda``):
    parameters, or a cache state."""
    return _convert(tree, resolve_device(device))
