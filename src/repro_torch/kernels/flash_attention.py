"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward), and their wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention`` and the custom VJP of ``repro/kernels/xla_flash.py``
(``_flash_fwd``, ``_flash_bwd``). A tensor on the CPU takes the plain
versions (:func:`ref.flash_attention_ref`,
:func:`ref.flash_attention_bwd_ref`); a CUDA tensor launches the kernels
or raises. Unlike the TPU kernel there is no block-divisibility rule:
the kernels mask ragged edges themselves. Head dims are multiples of 8
(the forward copies 16-byte vectors and feeds tensor-core tiles of 8),
q/k's up to 192 and v's up to 128, as MLA's prefill needs (D 192, Dv
128).

With grad enabled and an input that requires it, the call is
:class:`FlashAttention`: the forward also writes each row's logsumexp,
saves ``(q, k, v, out, lse)``, and the backward launches the backward
kernel. Otherwise the call launches the forward alone with no lse, as a
served CUDA graph captures it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, meta, ref

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_QK_HEAD_DIM = 192
MAX_V_HEAD_DIM = 128

counter = _build.LaunchCounter()       # forward launches
bwd_counter = _build.LaunchCounter()   # backward launches (3 kernels each)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k: (B,Sk,KV,D); v: (B,Sk,KV,Dv) -> (B,Sq,H,Dv) in
    q's dtype. The causal diagonal is offset by ``Sk - Sq``; ``window``
    applies with ``causal`` only. Differentiable in q, k and v. Inside
    :func:`meta.shapes_only`, ``meta`` tensors take the meta branch."""
    if q.device.type not in ("cuda", "cpu") and not meta.takes(q):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    if q.is_cuda:
        return _launch(q, k, v, causal, window, scale)[0]
    if q.is_meta:
        return _meta_fwd(q, k, v, causal, window, False)[0]
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             window: int = 0,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward and each row's logsumexp (B,Sq,H) f32, without
    autograd: the forward kernel with its lse on CUDA (one launch), the
    plain version on the CPU. For combining partial softmaxes over
    slices of the keys; a row that sees no key has lse +inf."""
    if q.is_cuda:
        return _launch(q, k, v, causal, window, scale, want_lse=True)
    if meta.takes(q):
        return _meta_fwd(q, k, v, causal, window, True)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True)


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its lse, and the backward kernel (the
    reference's ``_flash`` custom VJP). On the CPU both are the plain
    versions, the backward block by block."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                scale: Optional[float]):
        if q.is_cuda:
            out, lse = _launch(q, k, v, causal, window, scale, want_lse=True)
        elif q.is_meta:
            out, lse = _meta_fwd(q, k, v, causal, window, True)
        else:
            out, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window, scale=scale,
                                               return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), causal, window, scale)
        return dq, dk, dv, None, None, None


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, window: int = 0,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) from the forward's ``out`` and lse (B,Sq,H) f32 and
    the output's gradient ``dout``, in q's, k's and v's dtypes. A CUDA
    tensor launches the backward kernel; a CPU tensor takes the plain
    blockwise version."""
    if q.is_cuda:
        return _launch_bwd(q, k, v, out, lse, dout, causal, window, scale)
    if meta.takes(q):
        _check_shapes(q, k, v)
        b, sq, h, d = q.shape
        pairs = meta.attention_pairs(b, sq, k.shape[1], h, causal, window)
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        # S and dP recomputed, dV, dK and dQ: the three kernels' products
        meta.add(2 * pairs * (4 * d + 3 * v.shape[3]), q, k, v, out, lse,
                 dout, *grads)
        return grads
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, window=window,
                                           scale=scale)
    raise ValueError(f"flash_attention_backward: unsupported device "
                     f"{q.device}")


def _meta_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, want_lse: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel's outputs, shapes only: out (B,Sq,H,Dv) and,
    under grad, the lse (B,Sq,H) f32; never the S x S scores."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    dv = v.shape[3]
    out = q.new_empty((b, sq, h, dv))
    lse = q.new_empty((b, sq, h), dtype=torch.float32) if want_lse else None
    meta.add(2 * meta.attention_pairs(b, sq, k.shape[1], h, causal, window)
             * (d + dv), q, k, v, out, *([lse] if want_lse else []))
    return out, lse


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D q, k, v")
    b, sq, h, d = q.shape
    _, sk, kvh, dv = v.shape
    if k.shape != (b, sk, kvh, d) or v.shape[0] != b:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if h % kvh:
        raise ValueError(f"q heads {h} not divisible by kv heads {kvh}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return the dtype code."""
    _check_shapes(q, k, v)
    d, dv = q.shape[3], v.shape[3]
    if d > MAX_QK_HEAD_DIM or dv > MAX_V_HEAD_DIM or d % 8 or dv % 8:
        raise ValueError(f"flash_attention kernel takes head dims that are "
                         f"multiples of 8, D up to {MAX_QK_HEAD_DIM} and Dv "
                         f"up to {MAX_V_HEAD_DIM}, got D={d} Dv={dv}")
    dtype = KERNEL_DTYPES.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or "
                        f"bfloat16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.get_device() == k.get_device() == v.get_device()):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention kernel needs 16-byte-aligned "
                         "q, k and v (16-byte copies)")
    return dtype


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, scale: Optional[float],
            want_lse: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    dtype = _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kvh, dv = v.shape[1], v.shape[2], v.shape[3]
    dev = q.get_device()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # empty_like is the cheapest allocation on the host (PERF.md §6)
    out = torch.empty_like(q) if dv == d else q.new_empty((b, sq, h, dv))
    lse = q.new_empty((b, sq, h), dtype=torch.float32) if want_lse else None
    rc = _build.entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if want_lse else None, dtype, b, sq, sk, h, kvh, d,
        dv, int(causal), int(window), float(scale), _build.stream(dev))
    if rc:
        _build.check(rc, "flash_attention")
    counter.add()
    return out, lse


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                causal: bool, window: int, scale: Optional[float]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dtype = _check(q, k, v)
    b, sq, h, d = q.shape
    sk, kvh, dv = v.shape[1], v.shape[2], v.shape[3]
    if out.shape != (b, sq, h, dv) or dout.shape != out.shape or \
            lse.shape != (b, sq, h):
        raise ValueError(f"flash_attention backward: out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}"
                         f" and v {tuple(v.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"flash_attention backward takes out and dout in "
                        f"q's dtype {q.dtype} and an f32 lse, got "
                        f"{out.dtype}, {dout.dtype}, {lse.dtype}")
    if not all(t.is_contiguous() and t.device == q.device
               for t in (out, dout, lse)):
        raise ValueError("flash_attention backward needs contiguous out, "
                         "dout and lse on q's device")
    if (out.data_ptr() | dout.data_ptr()) % 16:
        raise ValueError("flash_attention backward needs 16-byte-aligned "
                         "out and dout")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty_like(lse)
    rc = _build.entry("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dvv.data_ptr(), dtype, b, sq, sk, h, kvh, d, dv,
        int(causal), int(window), float(scale),
        _build.stream(q.get_device()))
    if rc:
        _build.check(rc, "flash_attention backward")
    bwd_counter.add()
    return dq, dk, dvv
