"""AdamW over a parameter tree: the reference's ``repro/train/optimizer.py``.

``moment_dtype`` keeps the first and second moments in another dtype
(``"bfloat16"`` for the largest configs), f32 by default; ``grad_clip``
scales the gradients by the global f32 norm over all leaves; decoupled
weight decay applies to leaves of two or more dims only.

Unlike the reference's pure function, ``update`` writes the parameters,
the moments and the step count in place, under ``torch.no_grad()``, and
returns the same tree and state: a full-width step holds one copy of
each (the reference's functional update returns new trees).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.train.tree import leaves, sq_norm as _sq_norm, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the parameters' device
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: Optional[str] = None     # None => f32
    grad_clip: float = 1.0

    def _mdtype(self) -> torch.dtype:
        return torch_dtype(self.moment_dtype) if self.moment_dtype \
            else torch.float32

    def init(self, params) -> AdamWState:
        md = self._mdtype()
        first = leaves(params)[0]

        def zeros(p):
            return torch.zeros(p.shape, dtype=md, device=p.device)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, params, state: AdamWState, grads,
               sq_norm: Callable[[Any], torch.Tensor] = _sq_norm
               ) -> Tuple[Any, AdamWState]:
        """One step from ``grads`` (the structure of ``params``): the
        parameters, ``state.mu``, ``state.nu`` and ``state.step`` are
        written in place and returned. ``sq_norm`` maps ``grads`` to
        the global squared norm the clip reads: the model's
        ``grad_sq_norm`` (a sharded model's sums over every rank's
        shards); by default, the sum over the leaves."""
        md = self._mdtype()
        state.step.add_(1)
        flat_g = leaves(grads)
        scale = None
        if self.grad_clip > 0:
            gnorm = torch.sqrt(sq_norm(grads))
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        t = state.step.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=t.device), t)
        for p, g, m, v in zip(leaves(params), flat_g, leaves(state.mu),
                              leaves(state.nu)):
            if scale is not None:
                g = g * scale.to(g.dtype)
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * torch.square(gf)
            delta = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps)
            if p.dim() >= 2:  # decoupled decay on matrices only
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - self.lr * delta)
            m.copy_(m_new.to(md))
            v.copy_(v_new.to(md))
        return params, state


def adamw(lr: float = 3e-4, **kw) -> AdamW:
    return AdamW(lr=lr, **kw)
