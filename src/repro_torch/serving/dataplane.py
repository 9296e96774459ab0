"""Typed zero-copy slab codec for the process-backed serving data plane:
a copy of the reference's ``repro.serving.dataplane``.

Serializing every batch through the shared-memory slab costs four
copies per direction (``pickle.dumps`` -> slab write -> ``bytes(view)``
-> ``pickle.loads``). This module replaces serialization with a *typed
header + raw bytes* layout so array payloads cross the slab with exactly
one copy per direction and are **consumed as zero-copy views** on the
receiving side.

Slot layout (one "slot" = one ring buffer inside the slab)::

    +--------+---------------------+--------- 64-byte aligned ---------+
    | header | record table        | raw tensor bytes ...              |
    +--------+---------------------+-----------------------------------+

    header  : magic u32 | kind u8 | count u32 | nrec u32 | data_end u64
    record  : dtype 16s | flags u8 | ndim u8 | pad 6x | shape 8*u64
              | offset u64 | nbytes u64

Two kinds:

* ``KIND_TYPED`` — every payload is a ``np.ndarray`` or a CPU
  ``torch.Tensor``: the record table gives (dtype, shape, offset) per
  item and the bytes live in the slot. A homogeneous batch (same dtype,
  shape and type) collapses to ONE stacked record (``FLAG_STACKED``):
  the encoder assembles the batch directly into a single ``(n, *shape)``
  slab view (``np.stack(..., out=view)``) and the decoder hands back the
  rows as views of one block.
* ``KIND_PICKLE`` — the fallback lane for anything else (or an array
  the typed lane cannot express, e.g. object/structured dtypes):
  ``pickle.dumps`` written after the header.

Differences from the reference, by design:

* **bfloat16 without ml_dtypes.** The reference name-codes numpy's
  extension dtypes through ``ml_dtypes``, which the port may not import.
  The port carries ``torch.bfloat16`` tensors by the name ``bfloat16``
  with their bits as uint16, as :func:`repro_torch.convert._leaf` does,
  and decodes them back to ``torch.bfloat16``.
* **torch tensors ride the typed lane.** A record for a CPU tensor sets
  ``FLAG_TORCH`` and decodes to a tensor (``torch.from_numpy`` of the
  view, so still zero-copy on the worker side). A CUDA tensor cannot
  cross a process through the slab and takes the pickle lane.

Standard numpy dtypes keep the reference's byte layout exactly
(``tests/test_torch_procpool.py`` compares the slot bytes).

A batch that does not fit the slot raises :class:`SlotOverflow` (the
pre-pickled bytes ride on the exception so the chunked-slab fallback in
:mod:`repro_torch.serving.procpool` never pickles twice).

Decoding with ``copy=False`` returns views aliasing the slot — the
zero-copy worker-side path; ``copy=True`` materializes owned arrays
(the dispatcher-side path: the slot is reused for the next batch as
soon as ownership hands back, so responses must not alias it).

Every encode/decode updates a :class:`DataplaneStats`, the accounting
``chip_smoke.py`` phase 4f reports as bytes copied a batch.
"""

from __future__ import annotations

import dataclasses
import pickle
import struct
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "DataplaneStats",
    "SlotOverflow",
    "decode_batch",
    "encode_batch",
    "slot_capacity",
]

MAGIC = 0x0DA7A1A7
KIND_TYPED = 1
KIND_PICKLE = 2
FLAG_STACKED = 1
FLAG_TORCH = 2

_ALIGN = 64
MAX_NDIM = 8
_DTYPE_CHARS = 16

_HEADER = struct.Struct("<IBIIQ")                 # magic kind count nrec end
_RECORD = struct.Struct(f"<{_DTYPE_CHARS}sBB6x{MAX_NDIM}QQQ")

# name-coded dtypes: token -> (torch dtype, numpy carrier of its bits)
_EXT_DTYPES = {"bfloat16": (torch.bfloat16, np.dtype(np.uint16))}


class SlotOverflow(Exception):
    """The batch does not fit the slot; ``data`` carries the pickled
    bytes when the pickle lane already serialized (chunked fallback
    reuses them instead of pickling twice)."""

    def __init__(self, needed: int, capacity: int,
                 data: Optional[bytes] = None):
        super().__init__(f"batch needs {needed} B > slot capacity "
                         f"{capacity} B")
        self.needed = needed
        self.capacity = capacity
        self.data = data


@dataclasses.dataclass
class DataplaneStats:
    """Per-channel transport accounting (one endpoint's view)."""

    typed_batches: int = 0          # batches on the typed zero-copy lane
    pickle_batches: int = 0         # batches on the pickle fallback lane
    chunk_messages: int = 0         # oversize chunk hops through the slab
    inline_messages: int = 0        # legacy oversize inline-pipe hops
    bytes_copied: int = 0           # raw bytes memcpy'd into/out of slabs
    pickle_bytes: int = 0           # bytes serialized through pickle
    payload_bytes: int = 0          # logical tensor bytes transported

    def add(self, other: "DataplaneStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _dtype_token(dt: np.dtype) -> Optional[bytes]:
    """Round-trippable <= 16-char token for a standard numpy dtype, or
    None (pickle lane)."""
    if dt.hasobject or dt.names is not None or dt.itemsize == 0:
        return None
    try:
        if np.dtype(dt.str) != dt:
            return None
    except TypeError:
        return None
    raw = dt.str.encode("ascii")
    return raw if len(raw) <= _DTYPE_CHARS else None


def _carrier(p: Any):
    """(numpy array over the payload's bytes, dtype token, flags) for a
    payload the typed lane carries, else None."""
    if isinstance(p, np.ndarray):
        tok = _dtype_token(p.dtype)
        return None if tok is None else (p, tok, 0)
    if isinstance(p, torch.Tensor) and p.device.type == "cpu" \
            and not p.requires_grad:
        t = p.contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().view(np.uint16),
                    b"bfloat16", FLAG_TORCH)
        try:
            arr = t.numpy()
        except TypeError:               # a dtype numpy cannot hold
            return None
        tok = _dtype_token(arr.dtype)
        return None if tok is None else (arr, tok, FLAG_TORCH)
    return None


def _resolve_dtype(token: bytes) -> np.dtype:
    """The numpy dtype a record's bytes are read as (the carrier of a
    name-coded dtype)."""
    tok = token.rstrip(b"\x00").decode("ascii")
    ext = _EXT_DTYPES.get(tok)
    return ext[1] if ext is not None else np.dtype(tok)


def _as_payload(arr: np.ndarray, token: bytes, flags: int) -> Any:
    if not flags & FLAG_TORCH:
        return arr
    ext = _EXT_DTYPES.get(token.rstrip(b"\x00").decode("ascii"))
    if ext is not None:
        return torch.from_numpy(arr.view(np.int16)).view(ext[0])
    return torch.from_numpy(arr)


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def slot_capacity(slot: memoryview) -> int:
    return len(slot)


def _typed_plan(payloads: Sequence[Any]):
    """Classify the batch for the typed lane: list of (carrier array,
    token, flags), or None -> pickle lane."""
    if not payloads:
        return None
    specs = []
    for p in payloads:
        spec = _carrier(p)
        if spec is None or spec[0].ndim > MAX_NDIM:
            return None
        specs.append(spec)
    return specs


def _slot_view(slot: memoryview, dt: np.dtype, shape, offset: int):
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return np.frombuffer(slot, dtype=dt, count=count,
                         offset=offset).reshape(shape)


def encode_batch(slot: memoryview, payloads: Sequence[Any],
                 stats: Optional[DataplaneStats] = None,
                 typed: bool = True,
                 guard: Optional[np.ndarray] = None) -> int:
    """Write one batch into `slot`; returns bytes used.

    ``typed=False`` forces the pickle lane (the legacy-transport compat
    mode). ``guard`` is a uint8 view over the slot's memory: any payload
    aliasing it (a worker echoing its zero-copy input views back as
    outputs) is copied out first, so the in-place header/data writes can
    never corrupt bytes they are still reading. Raises
    :class:`SlotOverflow` when the batch cannot fit.
    """
    cap = len(slot)
    specs = _typed_plan(payloads) if typed else None
    if specs is None:
        data = pickle.dumps(payloads, protocol=pickle.HIGHEST_PROTOCOL)
        need = _HEADER.size + len(data)
        if need > cap:
            raise SlotOverflow(need, cap, data=data)
        _HEADER.pack_into(slot, 0, MAGIC, KIND_PICKLE, len(payloads), 0,
                          need)
        slot[_HEADER.size:need] = data
        if stats is not None:
            stats.pickle_batches += 1
            stats.pickle_bytes += len(data)
            stats.bytes_copied += len(data)
        return need

    n = len(specs)
    first, first_tok, first_flags = specs[0]
    stacked = (n > 1 and all(
        tok == first_tok and flags == first_flags
        and p.shape == first.shape for p, tok, flags in specs))
    nrec = 1 if stacked else n
    data_off = _align(_HEADER.size + nrec * _RECORD.size)
    total_payload = sum(p.nbytes for p, _, _ in specs)
    need = data_off + total_payload
    if need > cap:
        raise SlotOverflow(need, cap)

    if guard is not None:
        guarded = []
        for p, tok, flags in specs:
            # bounds-overlap check only (never the exact-overlap
            # solver); a false positive just costs one defensive copy
            if p.nbytes and np.may_share_memory(p, guard):
                p = p.copy()
            guarded.append((p, tok, flags))
        specs = guarded

    off = data_off
    if stacked:
        shape = (n,) + first.shape
        _RECORD.pack_into(
            slot, _HEADER.size, first_tok, FLAG_STACKED | first_flags,
            len(shape), *shape, *((0,) * (MAX_NDIM - len(shape))), off,
            total_payload)
        view = _slot_view(slot, specs[0][0].dtype, shape, off)
        np.stack([p for p, _, _ in specs], out=view)
        off += total_payload
    else:
        rec_off = _HEADER.size
        for p, tok, flags in specs:
            _RECORD.pack_into(
                slot, rec_off, tok, flags, p.ndim, *p.shape,
                *((0,) * (MAX_NDIM - p.ndim)), off, p.nbytes)
            if p.nbytes:
                view = _slot_view(slot, p.dtype, p.shape, off)
                np.copyto(view, p, casting="no")
            off += p.nbytes
            rec_off += _RECORD.size
    _HEADER.pack_into(slot, 0, MAGIC, KIND_TYPED, n, nrec, off)
    if stats is not None:
        stats.typed_batches += 1
        stats.bytes_copied += total_payload
        stats.payload_bytes += total_payload
    return need


def decode_batch(slot: memoryview, copy: bool,
                 stats: Optional[DataplaneStats] = None) -> List[Any]:
    """Read one batch out of `slot`.

    ``copy=False`` returns arrays aliasing the slot (the worker-side
    zero-copy path — valid only while this endpoint owns the buffer);
    ``copy=True`` returns owned arrays (the dispatcher-side path)."""
    magic, kind, count, nrec, end = _HEADER.unpack_from(slot, 0)
    if magic != MAGIC:
        raise ValueError(f"corrupt slot header (magic {magic:#x})")
    if kind == KIND_PICKLE:
        data = bytes(slot[_HEADER.size:end])
        if stats is not None:
            stats.bytes_copied += len(data)
            stats.pickle_bytes += len(data)
        return pickle.loads(data)

    out: List[Any] = []
    rec_off = _HEADER.size
    for _ in range(nrec):
        tok, flags, ndim, *rest = _RECORD.unpack_from(slot, rec_off)
        shape = tuple(rest[:ndim])
        off, nbytes = rest[MAX_NDIM], rest[MAX_NDIM + 1]
        view = _slot_view(slot, _resolve_dtype(tok), shape, off)
        if copy:
            view = view.copy()
            if stats is not None:
                stats.bytes_copied += nbytes
        if stats is not None:
            stats.payload_bytes += nbytes
        if flags & FLAG_STACKED:
            # rows: views of one block, no copy. Indexed with `...` so
            # 0-d rows stay arrays (plain iteration would scalar-ify)
            out.extend(_as_payload(view[i, ...], tok, flags)
                       for i in range(view.shape[0]))
        else:
            out.append(_as_payload(view, tok, flags))
        rec_off += _RECORD.size
    return out
