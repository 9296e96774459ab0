"""Training loop: the train-step factory and a small driver, the
reference's ``repro/train/trainer.py``.

``make_train_step`` returns the ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` function: the gradient of ``Model.loss`` over
every leaf of the parameter tree by ``torch.autograd.grad``, then
``AdamW.update`` (in place). There is no ``jit``: steps run eagerly, and
on CUDA the model's norms and attention run the port's kernels forward
and backward.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (TYPE_CHECKING, Any, Callable, Dict, Iterator, Optional,
                    Tuple)

import torch

from repro_torch.device import torch_dtype
from repro_torch.train.optimizer import AdamW
from repro_torch.train.tree import leaves, unflatten

if TYPE_CHECKING:      # the model imports repro_torch.train.tree
    from repro_torch.models.model import Model


def _value_and_grad(model: Model, params, batch) -> Tuple[torch.Tensor,
                                                           list]:
    flat = leaves(params)
    for p in flat:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss = model.loss(params, batch)
    # a leaf the loss does not reach (MTP with enable_mtp False) gets
    # zeros, as jax.grad gives it
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


def make_train_step(model: Model, opt: AdamW, microbatches: int = 1,
                    accum_dtype=None
                    ) -> Callable[..., Tuple[Any, Any, Dict[str, Any]]]:
    """One optimizer step; with ``microbatches > 1`` the global batch is
    split along dim 0 into that many microbatches, each one's gradient
    accumulated in ``accum_dtype`` (f32 by default) and the sum scaled by
    ``1 / microbatches`` into the parameters' dtypes (standard gradient
    accumulation: activation memory scales with the microbatch). The
    parameter leaves are made to require grad on the first call. The
    model's ``grad_sq_norm`` gives the clip the global norm (a sharded
    model, :class:`repro_torch.models.parallel.ShardedModel`, takes this
    rank's shards and rows and sums the norm over the mesh)."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(model, params, batch)
            params, opt_state = opt.update(params, opt_state,
                                           unflatten(params, grads),
                                           sq_norm=model.grad_sq_norm)
            return params, opt_state, {"loss": loss}

        adt = torch_dtype(accum_dtype) if isinstance(accum_dtype, str) \
            else (accum_dtype or torch.float32)
        flat = leaves(params)
        acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
               for p in flat]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=flat[0].device)
        for i in range(microbatches):
            mbatch = {k: x.reshape((microbatches, x.shape[0] // microbatches)
                                   + tuple(x.shape[1:]))[i]
                      for k, x in batch.items()}
            loss, grads = _value_and_grad(model, params, mbatch)
            for a, g in zip(acc, grads):
                a.add_(g.to(adt))
            loss_sum = loss_sum + loss
        inv = 1.0 / microbatches
        grads = unflatten(params, [(a * inv).to(p.dtype)
                                   for a, p in zip(acc, flat)])
        params, opt_state = opt.update(params, opt_state, grads,
                                       sq_norm=model.grad_sq_norm)
        return params, opt_state, {"loss": loss_sum * inv}

    return train_step


@dataclasses.dataclass
class Trainer:
    model: Model
    opt: AdamW
    log_every: int = 10

    def fit(self, params, data: Iterator[Dict[str, Any]], steps: int,
            callback: Optional[Callable[[int, float], None]] = None):
        """``steps`` steps over ``data`` (numpy batches, moved to the
        model's device); returns (params, opt_state, losses)."""
        step_fn = make_train_step(self.model, self.opt)
        opt_state = self.opt.init(params)
        dev = self.model.device
        losses = []
        t0 = time.time()
        for i, batch in enumerate(data):
            if i >= steps:
                break
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if callback:
                callback(i, loss)
            if self.log_every and i % self.log_every == 0:
                dt = time.time() - t0
                print(f"step {i:5d}  loss {loss:.4f}  ({dt:.1f}s elapsed)",
                      flush=True)
        return params, opt_state, losses
