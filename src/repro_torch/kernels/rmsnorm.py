"""Fused RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its wrapper.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``. A tensor on
the CPU takes the plain version (:func:`ref.rmsnorm_ref`); a CUDA tensor
launches the kernel or raises.

With grad enabled and an input that requires it, the call is
:class:`RMSNorm`: the forward is the same kernel (or plain version), and
the backward is the closed form of the gradient of
:func:`ref.rmsnorm_ref` in torch, with no kernel of its own. The
reference has no backward kernel either: off the TPU its gradient is
autodiff of the jnp oracle, and the backward's few elementwise passes
and one row reduction move the same bytes as the forward.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, meta, ref

# entry point, and the alignment its 4-element vector loads need (bytes)
KERNEL_DTYPES = {torch.float32: ("rmsnorm_f32", 16),
                 torch.bfloat16: ("rmsnorm_bf16", 8)}
MAX_D = 16384                 # a CTA of 256 threads x 16 vectors of 4

counter = _build.LaunchCounter()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,). ``x * rsqrt(mean(x^2) + eps)`` cast to
    ``x.dtype``, times ``scale`` cast to ``x.dtype``. Differentiable in x
    and scale. Inside :func:`meta.shapes_only`, ``meta`` tensors take
    the meta branch."""
    if x.device.type not in ("cuda", "cpu") and not meta.takes(x):
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    if x.is_cuda:
        return _launch(x, scale, eps)
    if x.is_meta:
        return _meta(x)
    return ref.rmsnorm_ref(x, scale, eps)


def _meta(x: torch.Tensor) -> torch.Tensor:
    """The kernel's output, shapes only: a square, a sum, a scale and a
    product an element."""
    out = torch.empty_like(x)
    meta.add(4 * x.numel(), x, out)
    return out


class RMSNorm(torch.autograd.Function):
    """The kernel's forward and the closed-form gradient of
    :func:`ref.rmsnorm_ref`. With ``x^ = x rsqrt(mean(x^2) + eps)`` and
    ``y = cast(x^, x.dtype) * scale``:

      g = cast(dy * scale, x.dtype)          the cast's cotangent
      dx = rstd (g - x^ mean(g x^))          in f32, cast to x.dtype
      dscale = sum over rows of dy cast(x^, x.dtype)
    """

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        if x.is_cuda:
            out = _launch(x, scale, eps)
        elif x.is_meta:
            out = _meta(x)
        else:
            out = ref.rmsnorm_ref(x, scale, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xf = x.float()
        rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = xf * rstd
        g = (dy * scale).to(x.dtype).float()
        dx = rstd * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
        dscale = (dy.float() * xhat.to(x.dtype).float()).reshape(
            -1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    # the launch path of every norm of a forward: each step here is host
    # time per call, so checks read plain attributes and ints
    fn_align = KERNEL_DTYPES.get(x.dtype)
    d = x.shape[-1]
    if fn_align is None:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    dev = x.get_device()
    if scale.shape != (d,) or scale.get_device() != dev:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on "
                         f"{scale.device} does not match x (..., {d}) on "
                         f"{x.device}")
    if d % 4 or d > MAX_D:
        raise ValueError(f"rmsnorm kernel needs D a multiple of 4 and at "
                         f"most {MAX_D}, got {d}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous x")
    if scale.dtype != x.dtype or not scale.is_contiguous():
        scale = scale.to(x.dtype).contiguous()
    fn, align = fn_align
    xp, sp = x.data_ptr(), scale.data_ptr()
    if (xp | sp) % align:
        raise ValueError("rmsnorm kernel needs 4-element-aligned tensors")
    out = torch.empty_like(x)
    rc = _build.entry(fn)(xp, sp, out.data_ptr(), x.numel() // d if d else 0,
                          d, eps, _build.stream(dev))
    if rc:
        _build.check(rc, "rmsnorm")
    counter.add()
    return out
