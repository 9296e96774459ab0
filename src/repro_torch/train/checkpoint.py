"""Parameter and optimizer-state checkpoints in the reference's ``.npz``
format (``repro/train/checkpoint.py``), so that either package restores
what the other saved.

Each leaf is stored under its path, the reference's
``jax.tree_util.tree_flatten_with_path`` key strings joined by ``/``
(``['embed']`` for a dict key, ``[0]`` for a tuple index, ``.mu`` for a
NamedTuple field: :func:`repro_torch.train.tree.flatten_with_path`).
bfloat16 leaves are stored as their uint16 bit patterns under the key
prefixed ``__bf16__`` (numpy has no bf16) and viewed back on restore:
lossless.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.train.tree import flatten_with_path, unflatten

_BF16_PREFIX = "__bf16__"


def _flatten(tree: Any) -> dict:
    out = {}
    for key, leaf in flatten_with_path(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            out[_BF16_PREFIX + key] = t.view(torch.uint16).numpy()
        else:
            out[key] = t.numpy()
    return out


def save(path: str, tree: Any) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)


def _decode(key: str, arr: np.ndarray):
    """(key, tensor) of a stored array; a bf16 leaf's bits viewed back."""
    if key.startswith(_BF16_PREFIX):
        return key[len(_BF16_PREFIX):], \
            torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return key, torch.from_numpy(arr)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor of the
    matching ``like`` leaf's dtype on its device. Raises on missing or
    extra keys and on a shape that differs."""
    with np.load(path) as data:
        stored = dict(_decode(k, data[k]) for k in data.files)
    flat = flatten_with_path(like)
    keys = {k for k, _ in flat}
    if set(stored) != keys:
        raise ValueError(f"checkpoint mismatch: missing="
                         f"{keys - set(stored)} extra={set(stored) - keys}")
    new_leaves = []
    for key, leaf in flat:
        t = stored[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        new_leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return unflatten(like, new_leaves)
