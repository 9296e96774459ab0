"""Sharded execution of every family of the zoo on a ``DeviceMesh``:
dense, MoE, MLA (with MTP), hybrid (Mamba), xLSTM, encoder-decoder
(whisper) and image (pixtral); FSDP over the data axes and tensor
parallelism over ``model``.

The reference gets sharded execution from GSPMD: it pins placements
(:mod:`repro.models.sharding`) and XLA inserts the collectives. Here
every rank holds its local shards (placed as
:func:`repro_torch.models.sharding.param_placements` says) and runs the
model on plain local tensors, with the collectives written out through
``torch.distributed._functional_collectives`` on the mesh's groups
(NCCL on the cards, gloo on the CPU, the ``fake`` backend in the
dry-run). The hand-written kernels (rmsnorm, flash and decode
attention) run unchanged on the local tensors; no DTensor reaches them.

* **FSDP.** Each layer's weights are all-gathered over the data axes
  just before the layer and dropped after (the ZeRO-3 resolution the
  reference's ``constrain_batch`` forces); under autograd the gather's
  backward is a reduce-scatter, and a weight replicated over the data
  axes has its gradient all-reduced there. With ``cfg.remat`` the
  gather is inside each layer's checkpoint, so the backward gathers
  again instead of keeping every layer's full weights. The batch goes
  over the data axes.
* **TP over ``model``** (Megatron's f and g: f is the identity forward
  and an all-reduce backward, g the reverse): attention heads are local
  (``wq``/``wk``/``wv`` and biases), ``wo`` is row-parallel and its
  output all-reduced; the MLP's ``wg``/``wu`` are column-parallel and
  ``wd`` row-parallel; the embedding is vocab-parallel (a masked lookup,
  then an all-reduce); the head is vocab-parallel and its logits stay
  sharded over the vocabulary (gathered by :meth:`gather_logits` where a
  caller needs them whole); the loss is a vocab-parallel cross entropy.
  MoE experts go over ``model``: every rank computes the same dispatch
  from the replicated router, runs its local experts and combines, then
  the output is all-reduced; the capacity rule is the reference's; a
  shared expert is the MLP above.
* **MLA** (DeepSeek): ``wq_b``, ``wkv_b_k`` and ``wkv_b_v`` hold the
  rank's heads; ``wq_a``, ``wkv_a`` and the latent norms are
  replicated, so every rank computes the whole latents, and f goes on
  the latents (``c_q``, ``c_kv``, ``k_rope``), so that their weights'
  gradients sum over every head; ``wo`` is row-parallel. The latent
  cache is whole on every model rank
  (:func:`~repro_torch.models.sharding.execution_cache_placements`):
  the absorbed decode runs the rank's heads over it. **MTP** runs its
  block as any layer, through the vocab-parallel head and cross
  entropy, its mean taken over the global batch.
* **Mamba** (Jamba): the rank's channels of ``D_in``: ``in_proj``
  column-parallel (run as ``(D, 2, D_in)``, the same channels of x and
  of the gate), the conv, dt, A, the skip and the carried state local,
  ``w_bc`` row-parallel with B and C made whole (then f, since every
  rank scans its channels with all of them), the scan on the local
  channels, ``out_proj`` row-parallel.
* **xLSTM**: an mLSTM's heads (``up`` run as ``(D, 2, D_in)`` and
  column-parallel, x's channels all-gathered for ``mq``/``mk``/``mv``,
  which are column-parallel over heads; ``w_i``/``w_f`` row-parallel,
  the gates' partial sums all-reduced; the state and the group norm per
  head; ``down`` row-parallel). Where ``model`` splits a head, the
  split weights are gathered over ``model`` and every rank runs the
  whole cell. An sLSTM's weights are replicated, as the reference
  places them, and so is its state: every rank runs the whole
  recurrence, with no collective inside its token loop.
* **Whisper**: the encoder's layers run as the decoder's (its specs in
  ``enc_specs``, ``in_proj`` gathered over the data axes); the
  cross-attention's heads are local, as self-attention's are, and so
  are the cross cache's; the encoder's states go through f into every
  cross-attention, so their gradient sums over the heads. **Pixtral**:
  ``img_proj`` gathered over the data axes, the image prefix's rows
  over the data axes with the text's.
* **The layout** is :func:`~repro_torch.models.sharding.
  execution_placements`: the reference's placements, but a stacked
  dense FFN weight has its hidden dimension over ``model`` (the rule the
  reference documents) where the reference's ``param_pspec`` puts the
  layer axis, and a Mamba ``in_proj`` runs as ``(D, 2, D_in)``. A
  dimension that does not divide its axis is replicated. The cache
  (:func:`~repro_torch.models.sharding.execution_cache_placements`) is
  the reference's but for MLA's latent (whole over ``model``), an
  mLSTM's stabilizer (the rank's heads) and an sLSTM's state (whole
  over ``model``); whisper's cross cache never splits its frames.
  KV heads that do not divide ``model`` (qwen2's 8 on 16,
  granite-34b's 1) leave ``wk``/``wv`` replicated: a rank computes every
  KV head and attends with the ones its query heads use; the cache then
  holds a slice of the SEQUENCE on each model rank. A decode step
  attends over each rank's own slots with the flash kernel, which gives
  each row's logsumexp (the decode kernel does not), and combines the
  partial softmaxes over that group (flash-decode, as the reference
  lets XLA do); a prefill writes each rank's own slots.

The layers are the unsharded model's own (:mod:`repro_torch.models.
layers`, :class:`~repro_torch.models.model.Model`'s layer loop): they
take a :class:`Parallel` in place of the one-rank
:class:`~repro_torch.models.layers.Local` and read which dimensions are
split from their weights' local shapes. This module holds what exists
only across ranks: the collectives, FSDP's per-layer gather, the
vocab-parallel embedding, head and cross entropy, the split-sequence
decode, the MoE's rows over the data axes, MTP's weights and batch
mean, each rank's init and the global gradient norm.

Every collective is counted (:class:`CollectiveStats`: kind, group
size, bytes of the output), for the roofline's collective term.

MLA's absorbed decode over a latent cache whose sequence is split over
the data axes (``shard_seq`` with more than one data rank) raises
``NotImplementedError``.
"""

from __future__ import annotations

import copy
import hashlib
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention_with_lse
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.kvcache import STABILIZER_INIT, init_cache
from repro_torch.models.model import Model, _cross_entropy
from repro_torch.models.sharding import (
    MODEL,
    _stacked,
    batch_placements,
    entry_axes,
    execution_cache_placements,
    execution_cross_placements,
    execution_placements,
    execution_view,
    local_shape,
    local_slices,
    mesh_axes,
)

Params = Dict[str, Any]
_all_gather = getattr(funcol, "all_gather_single", None) or \
    funcol.all_gather_tensor
_reduce_scatter = getattr(funcol, "reduce_scatter_single", None) or \
    funcol.reduce_scatter_tensor


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


# ---------------------------------------------------------------------------
# the mesh's groups and the collectives
# ---------------------------------------------------------------------------

class CollectiveStats:
    """Every collective issued: ``{(kind, group size): [calls, bytes]}``,
    bytes being the output's (the reference's HLO count's convention)."""

    def __init__(self):
        self.by_kind: Dict[Tuple[str, int], list] = {}

    def add(self, kind: str, n: int, out: torch.Tensor) -> None:
        rec = self.by_kind.setdefault((kind, n), [0, 0])
        rec[0] += 1
        rec[1] += out.numel() * out.element_size()

    def reset(self) -> None:
        self.by_kind.clear()

    def bytes_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (kind, _), (_, b) in self.by_kind.items():
            out[kind] = out.get(kind, 0) + b
        return out


class Parallel(L.Local):
    """One rank's view of a ``(data..., model)`` mesh: its coordinates,
    the model group and the flattened data group, and the collectives.
    A group of one rank issues nothing. ``rows_over_data`` says the
    batch a model gets is this rank's rows of a global batch split over
    the data axes; False means every data rank gets the whole batch
    (long_500k's batch of 1). ``seq`` is the spec entry of the cache's
    sequence in a run over a cache (:meth:`for_cache`)."""

    def __init__(self, mesh, rows_over_data: bool = True):
        names, sizes = mesh_axes(mesh)
        if MODEL not in names:
            raise ValueError(f"mesh axes {names} have no 'model' axis")
        self.mesh = mesh
        self.rows_over_data = rows_over_data
        self.seq = None
        self.fsdp_axes = tuple(n for n in names if n != MODEL)
        coord = mesh.get_coordinate()
        self.coords = dict(zip(names, coord))
        self.model_size = sizes[MODEL]
        self.model_rank = self.coords[MODEL]
        self.data_size, self.data_rank = 1, 0
        for a in self.fsdp_axes:
            self.data_size *= sizes[a]
            self.data_rank = self.data_rank * sizes[a] + self.coords[a]
        self.world = self.model_size * self.data_size
        self.model_group = mesh.get_group(MODEL) if self.model_size > 1 \
            else None
        self.data_group = None
        if self.data_size > 1:
            if len(self.fsdp_axes) == 1:
                self.data_group = mesh.get_group(self.fsdp_axes[0])
            else:
                self.data_group = mesh[self.fsdp_axes]._flatten().get_group()
        self.stats = CollectiveStats()

    def group(self, entry) -> Tuple[Any, int, int]:
        """(group, size, this rank's index) of a spec entry: ``"model"``
        or the data axes."""
        if entry == MODEL:
            return self.model_group, self.model_size, self.model_rank
        return self.data_group, self.data_size, self.data_rank

    # raw collectives (no autograd)
    def all_reduce(self, x: torch.Tensor, entry=MODEL,
                   op: str = "sum") -> torch.Tensor:
        group, n, _ = self.group(entry)
        if n == 1:
            return x
        out = _wait(funcol.all_reduce(x, op, group))
        self.stats.add("all-reduce", n, out)
        return out

    def all_gather(self, x: torch.Tensor, dim: int,
                   entry=MODEL) -> torch.Tensor:
        group, n, _ = self.group(entry)
        if n == 1:
            return x
        out = _wait(_all_gather(x.contiguous(), dim, group))
        self.stats.add("all-gather", n, out)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       entry=MODEL) -> torch.Tensor:
        group, n, _ = self.group(entry)
        if n == 1:
            return x
        out = _wait(_reduce_scatter(x.contiguous(), "sum", dim, group))
        self.stats.add("reduce-scatter", n, out)
        return out

    # differentiable forms
    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: identity forward, all-reduce over ``model``
        backward (a replicated tensor a rank uses in part)."""
        if self.model_size == 1 or not _needs_grad(x):
            return x
        return _Copy.apply(x, self, MODEL)

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g: all-reduce over ``model`` forward, identity
        backward (partial sums made whole)."""
        if self.model_size == 1:
            return x
        if not _needs_grad(x):
            return self.all_reduce(x)
        return _Reduce.apply(x, self, MODEL)

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce over the data axes forward, identity backward."""
        if self.data_size == 1:
            return x
        if not _needs_grad(x):
            return self.all_reduce(x, "data")
        return _Reduce.apply(x, self, "data")

    def gather_data(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather over the data axes; the backward reduce-scatters."""
        return self._gather(x, dim, "data", True)

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather over ``model``; the backward reduce-scatters."""
        return self._gather(x, dim, MODEL, True)

    def whole(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather over ``model`` for a computation every model rank
        repeats on the same inputs: each rank's gradient is then the
        whole one, and the backward keeps this rank's slice of it."""
        return self._gather(t, dim, MODEL, False)

    def _gather(self, x: torch.Tensor, dim: int, entry,
                reduce: bool) -> torch.Tensor:
        _, n, _ = self.group(entry)
        if n == 1:
            return x
        if not _needs_grad(x):
            return self.all_gather(x, dim, entry)
        return _Gather.apply(x, dim, self, entry, reduce)

    def weight(self, p: torch.Tensor, spec) -> torch.Tensor:
        """A weight for use: its data-sharded dim all-gathered
        (reduce-scattered backward); a weight replicated over the data
        axes has its gradient all-reduced there."""
        for d, entry in enumerate(spec):
            if entry is not None and entry != MODEL:
                return self.gather_data(p, d)
        if self.data_size > 1 and _needs_grad(p):
            return _Copy.apply(p, self, "data")
        return p

    # the layers' hooks (repro_torch.models.layers.Local)
    def layer(self, p, spec):
        """One layer's weights, each all-gathered over the data axes
        (FSDP; dropped after the layer)."""
        if self.data_size == 1:
            return p
        return _map2(self.weight, p, spec)

    def for_cache(self, specs) -> "Parallel":
        """This view for a run over a cache placed by ``specs``: its
        sequence's entry set (every attention layer's is the same)."""
        view = copy.copy(self)
        view.seq = next((blk["k"][2] for seg in specs for blk in seg
                         if "k" in blk), None)
        return view

    def cache_slots(self, slots: int) -> Tuple[int, int, int]:
        if self.seq is None:
            return 0, slots, slots
        _, n, i = self.group(self.seq)
        return i * slots, slots, slots * n

    def split_decode(self, q: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor, lo: int, valid_len: int,
                     heads: slice, heads_tp: bool,
                     cd: torch.dtype) -> torch.Tensor:
        """Decode attention over a cache whose sequence is split over
        the group of ``self.seq`` (flash-decode): each rank attends over
        its own valid slots with the flash kernel, which also gives each
        row's logsumexp, and the partial softmaxes combine in three
        small all-reduces (the max, the weighted outputs, the weights).
        Over ``model`` the ranks' query heads differ, so each first
        gathers every head's query (a few KB) and keeps its own heads
        after."""
        entry, hl = self.seq, q.shape[2]
        every_head = entry == MODEL and heads_tp
        if every_head:
            q = self.all_gather(q, 2, MODEL)
        else:
            ck, cv = ck[:, :, heads], cv[:, :, heads]
        n = max(0, min(valid_len - lo, ck.shape[1]))
        if n:
            out, lse = flash_attention_with_lse(
                q.to(cd).contiguous(), ck[:, :n].to(cd).contiguous(),
                cv[:, :n].to(cd).contiguous(), causal=False)
        else:
            out = q.new_zeros(q.shape[:3] + (cv.shape[3],), dtype=cd)
            lse = torch.full(q.shape[:3], float("-inf"), device=q.device)
        m = self.all_reduce(lse, entry, op="max")
        w = torch.exp(lse - m)
        num = self.all_reduce(out.float() * w[..., None], entry)
        out = (num / self.all_reduce(w, entry)[..., None]).to(cd)
        if every_head:
            h0 = self.model_rank * hl
            out = out[:, :, h0:h0 + hl]
        return out

    def _route_over(self) -> int:
        """The data ranks whose rows are split apart."""
        return self.data_size if self.rows_over_data else 1

    def moe_rows(self, x: torch.Tensor, groups: int
                 ) -> Tuple[torch.Tensor, int]:
        """When the rows are split over the data axes and the routing
        groups align with them (the dry-run's ``moe_groups`` = the data
        size), each rank routes its own groups; otherwise the rows are
        gathered over the data axes and routed as one batch."""
        nd = self._route_over()
        if nd == 1:
            return x, groups
        b, s = x.shape[:2]
        if groups % nd == 0 and (b * s * nd) % groups == 0:
            return x, groups // nd
        return self.gather_data(x, 0), groups

    def moe_own(self, out: torch.Tensor, aux: torch.Tensor, b: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of gathered ones (the aux then counted once
        over the data axes), or the aux's mean over the data axes."""
        nd = self._route_over()
        if out.shape[0] != b:
            return (out[self.data_rank * b:(self.data_rank + 1) * b],
                    _scale_grad(aux, 1.0 / nd))
        if nd > 1:
            return out, self.sum_data(aux) / nd
        return out, aux


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce over the group of ``entry`` backward
    (Megatron's f over ``model``; a data-replicated weight's gradient)."""

    @staticmethod
    def forward(ctx, x, par, entry):
        ctx.par, ctx.entry = par, entry
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.par.all_reduce(g.contiguous(), ctx.entry), None, None


class _Reduce(torch.autograd.Function):
    """All-reduce over the group of ``entry`` forward, identity backward
    (Megatron's g over ``model``; a loss summed over the data axes)."""

    @staticmethod
    def forward(ctx, x, par, entry):
        return par.all_reduce(x.contiguous(), entry)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather over the group of ``entry``; the backward
    reduce-scatters (``reduce``) or keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, par, entry, reduce):
        ctx.par, ctx.dim, ctx.entry, ctx.reduce = par, dim, entry, reduce
        return par.all_gather(x, dim, entry)

    @staticmethod
    def backward(ctx, g):
        par, dim, entry = ctx.par, ctx.dim, ctx.entry
        if ctx.reduce:
            g = par.reduce_scatter(g, dim, entry)
        else:
            _, n, i = par.group(entry)
            g = g.chunk(n, dim)[i]
        return g, None, None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s: float):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    return _ScaleGrad.apply(x, s) if s != 1.0 and _needs_grad(x) else x


# ---------------------------------------------------------------------------
# trees of shards
# ---------------------------------------------------------------------------

def _map2(fn, tree, specs):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _layer_specs(tree):
    """A stacked segment's specs with the leading repeat entry dropped."""
    if isinstance(tree, dict):
        return {k: _layer_specs(v) for k, v in tree.items()}
    return tuple(tree[1:])


def _segment_specs(segments):
    """Each segment's per-layer specs, a block at a time."""
    return tuple(tuple(_layer_specs(b) for b in seg) for seg in segments)


def shard_params(params, mesh, coords: Optional[Dict[str, int]] = None,
                 device=None):
    """One rank's local shards of a full parameter tree (of
    ``execution_view(params)``, placed by ``execution_placements``), as
    contiguous copies on ``device`` (default: each leaf's own).
    ``coords`` are the rank's mesh coordinates ({axis: index}; default:
    this process's)."""
    if coords is None:
        names, _ = mesh_axes(mesh)
        coords = dict(zip(names, mesh.get_coordinate()))
    specs = execution_placements(params, mesh)
    return _map2(lambda leaf, spec: leaf[local_slices(
        leaf.shape, spec, mesh, coords)].to(device or leaf.device,
                                            copy=True).contiguous(),
        execution_view(params), specs)


def shard_batch(batch: Dict[str, torch.Tensor], mesh,
                coords: Optional[Dict[str, int]] = None):
    """One rank's rows of a global batch (the batch dim over the data
    axes when it divides, else every row)."""
    if coords is None:
        names, _ = mesh_axes(mesh)
        coords = dict(zip(names, mesh.get_coordinate()))
    specs = batch_placements(batch, mesh)
    return {k: v[local_slices(v.shape, specs[k], mesh, coords)]
            for k, v in batch.items()}


# the init of the random leaves, by the last key of their path: N(0, 1)
# times the scale, as Model.init draws them
def _init_scale(path: Tuple, shape: Tuple[int, ...], cfg: ArchConfig
                ) -> Optional[float]:
    key = path[-1]
    if key in ("embed", "unembed") or path[-2:] == ("mtp", "proj"):
        return 0.02
    if key == "img_proj" or path[-2:] == ("encoder", "in_proj"):
        return 0.05
    if key in _FILLS:
        return None
    if key == "conv_w":
        return 0.5
    if key == "wo":
        hd = cfg.v_head_dim if cfg.use_mla else cfg.resolved_head_dim
        return 1.0 / math.sqrt(cfg.num_heads * hd)
    fan_in = shape[1 if _stacked(path) else 0]
    return (0.5 if key == "r_h" else 1.0) / math.sqrt(max(fan_in, 1))


# the deterministic leaves, as Model.init makes them: a value, or a row
# of the channels' (Mamba's A: log 1..N for every channel; the sLSTM's
# bias: 0 for z and i, 3 for f, 0 for o)
_FILLS = {"scale": 1.0, "q_norm": 1.0, "kv_norm": 1.0, "bq": 0.0,
          "bk": 0.0, "bv": 0.0, "w_dt": 0.1, "b_dt": -2.0, "d_skip": 1.0,
          "a_log": lambda n: torch.log(torch.arange(1, n + 1,
                                                    dtype=torch.float32)),
          "b_i": 0.0, "b_f": 3.0, "out_norm": 1.0,
          "bias": lambda n: torch.cat([torch.zeros(n // 2),
                                       torch.full((n // 4,), 3.0),
                                       torch.zeros(n // 4)])}


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------

class ShardedModel(Model):
    """The model over ``mesh``; every method takes and returns this
    rank's local shards, batch rows and cache.

    ``batch_over_data`` says the batch a method gets is this rank's rows
    of a global batch split over the data axes (the default); False
    means every data rank gets the whole batch (long_500k's batch of 1).

    Entry points, as :class:`Model`'s:
      init_local(seed)                      -> local params
      forward(params, batch)                -> (logits (B,S,V/model) f32,
                                                aux)
      gather_logits(logits)                 -> (B,S,V)
      loss(params, batch)                   -> scalar, the global loss
      init_cache(batch, smax, shard_seq)    -> local cache state
      prefill(params, batch, smax)          -> (last logits, cache state)
      decode_step(params, token, pos, cache) -> (logits, cache state)
    """

    def __init__(self, cfg: ArchConfig, mesh, device: torch.device,
                 batch_over_data: bool = True):
        super().__init__(cfg, device)
        self.mesh = mesh
        self.batch_over_data = batch_over_data
        self.par = Parallel(mesh, batch_over_data)
        full = Model(cfg, torch.device("meta")).init(None)
        self.full = execution_view(full)
        self.specs = execution_placements(full, mesh)
        self.seg_specs = _segment_specs(self.specs["segments"])
        if cfg.is_encoder_decoder:
            enc = self.specs["encoder"]
            self.enc_specs = {**enc,
                              "segments": _segment_specs(enc["segments"])}
        emb = self.specs["embed"]
        self.vocab_tp = self.par.model_size > 1 and (
            emb[0] if cfg.tie_embeddings
            else self.specs["unembed"][1]) == MODEL
        self._layouts: Dict[tuple, Any] = {}

    # ------------------------------------------------------------ params
    def init_local(self, seed: int = 0) -> Params:
        """This rank's shards drawn directly, as :meth:`Model.init` draws
        the full leaves (N(0, 1) times the leaf's scale), from ``seed``,
        the same on every rank: each shard from a generator of its own,
        seeded by ``seed``, the leaf's path and
        the shard's index on the axes that split the leaf, so that the
        ranks holding one shard (a leaf replicated over ``model``, a
        batch-split mesh's copies) hold the same values and two shards
        differ. The deterministic leaves (norm scales, biases, Mamba's
        dt, A and skip) are the full leaves' rows. No rank holds the
        whole tree. On ``meta``, shapes only."""
        cfg, dev = self.cfg, self.device
        names, _ = mesh_axes(self.mesh)
        coords = dict(zip(names, self.mesh.get_coordinate()))

        def shard_generator(path, spec) -> torch.Generator:
            shard = [coords[a] for entry in spec for a in entry_axes(entry)]
            key = hashlib.blake2b(repr((seed, path, shard)).encode(),
                                  digest_size=7).digest()
            return torch.Generator(device=dev).manual_seed(
                int.from_bytes(key, "little"))

        def leaf(path, full, spec):
            shape = local_shape(full.shape, spec, self.mesh)
            scale = _init_scale(path, tuple(full.shape), cfg)
            if dev.type == "meta":
                return torch.empty(shape, dtype=full.dtype, device=dev)
            if scale is None:
                fill = _FILLS[path[-1]]
                if callable(fill):
                    row = fill(shape[-1]).to(dev, full.dtype)
                    return row.expand(shape).contiguous()
                return torch.full(shape, fill, dtype=full.dtype, device=dev)
            generator = shard_generator(path, spec)
            out = torch.empty(shape, dtype=full.dtype, device=dev)
            # a layer at a time: one layer's f32 draw is all the extra
            # memory (qwen2-72b's FFN stack is 19 GB a card in f32)
            for layer in (out if _stacked(path) else (out,)):
                layer.copy_(torch.randn(layer.shape, generator=generator,
                                        device=dev).mul_(scale))
            return out

        def walk(full, spec, path):
            if isinstance(full, dict):
                return {k: walk(full[k], spec[k], path + (k,))
                        for k in full}
            if isinstance(full, tuple):
                return tuple(walk(f, s, path + (i,))
                             for i, (f, s) in enumerate(zip(full, spec)))
            return leaf(path, full, spec)

        return walk(self.full, self.specs, ())

    # ------------------------------------------ the vocabulary over model
    def _embed_tokens(self, params: Params,
                      tokens: torch.Tensor) -> torch.Tensor:
        """A masked lookup in this rank's rows of the vocabulary, made
        whole by an all-reduce over ``model``."""
        par, spec = self.par, self.specs["embed"]
        w = par.weight(params["embed"], spec).to(self.cfg.cdtype)
        if not self.vocab_tp:
            return w[tokens]
        vl = w.shape[0]
        ids = tokens - par.model_rank * vl
        ok = (ids >= 0) & (ids < vl)
        x = torch.where(ok[..., None], w[ids.clamp(0, vl - 1)], 0.0)
        return par.from_model(x)

    def _head(self, params: Params, x: torch.Tensor,
              norm: Optional[Params] = None) -> torch.Tensor:
        """Logits of this rank's columns of the vocabulary."""
        cfg, par = self.cfg, self.par
        norm = params["final_norm"] if norm is None else norm
        x = L.ops.rmsnorm(x, par.weight(norm["scale"],
                                        self.specs["final_norm"]["scale"]),
                          cfg.norm_eps)
        if cfg.tie_embeddings:
            w = par.weight(params["embed"], self.specs["embed"]).T
        else:
            w = par.weight(params["unembed"], self.specs["unembed"])
        if self.vocab_tp:
            x = par.to_model(x)
        return torch.einsum("bsd,dv->bsv", x, w.to(cfg.cdtype)).float()

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary of vocab-sharded logits (no grad)."""
        if not self.vocab_tp:
            return logits
        return self.par.all_gather(logits.detach(), logits.dim() - 1)

    def _cross_entropy(self, logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
        """Per-token cross entropy of vocab-sharded logits: the max and
        the sum of exponentials all-reduced over ``model``, the target's
        logit from the rank that holds it."""
        if not self.vocab_tp:
            return _cross_entropy(logits, targets)
        par = self.par
        lf = logits.float()
        m = par.all_reduce(lf.amax(dim=-1).detach(), op="max")
        sumexp = torch.exp(lf - m[..., None]).sum(dim=-1)
        vl = lf.shape[-1]
        ids = targets.long() - par.model_rank * vl
        ok = (ids >= 0) & (ids < vl)
        tgt = torch.gather(lf, -1, ids.clamp(0, vl - 1)[..., None])[..., 0]
        tgt = par.from_model(torch.where(ok, tgt, 0.0))
        return torch.log(par.from_model(sumexp)) + m - tgt

    # ------------------------------------------------------------- MTP
    def _mtp_params(self, params: Params) -> Params:
        """The MTP module's projection and block, all-gathered over the
        data axes; its norm as it is (the head gathers it)."""
        mtp, spec = params["mtp"], self.specs["mtp"]
        return {"proj": self.par.weight(mtp["proj"], spec["proj"]),
                "block": self.par.layer(mtp["block"], spec["block"]),
                "norm": mtp["norm"]}

    def _batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's mean of this rank's per-token values (every
        data rank holds as many rows)."""
        par = self.par
        if not self.batch_over_data or par.data_size == 1:
            return x.mean()
        return par.sum_data(x.sum()) / (x.numel() * par.data_size)

    # --------------------------------------------------- over the mesh
    def _mean_loss(self, num: torch.Tensor, den: torch.Tensor,
                   aux: torch.Tensor) -> torch.Tensor:
        """The global batch's mean, the same on every rank; its gradient,
        through the collectives' backwards, is this rank's part of every
        leaf's."""
        par = self.par
        if self.batch_over_data:
            num, den = par.sum_data(num), par.all_reduce(den, "data")
        loss = num / torch.clamp(den, min=1.0) + aux
        if not self.batch_over_data:
            loss = _scale_grad(loss, 1.0 / par.data_size)
        return loss

    def grad_sq_norm(self, grads) -> torch.Tensor:
        """The global squared norm of a gradient tree of local shards:
        each leaf's local sum of squares, weighted by the share of the
        mesh that holds the same shard, all-reduced over the mesh."""
        pairs: list = []
        _map2(lambda g, spec: pairs.append((g, spec)), grads, self.specs)
        sizes = mesh_axes(self.mesh)[1]
        total = None
        for g, spec in pairs:
            shards = 1
            for entry in spec:
                for axis in entry_axes(entry):
                    shards *= sizes[axis]
            sq = torch.sum(torch.square(g.float())) * (
                shards / self.par.world)
            total = sq if total is None else total + sq
        return self.par.all_reduce(self.par.all_reduce(total), "data")

    # ------------------------------------------------------------ cache
    def init_cache(self, batch: int, smax: int, shard_seq: bool = False,
                   device=None):
        """This rank's part of the cache of a global ``batch``: (cache,
        cross, specs), the cache placed by ``execution_cache_placements``
        (MLA's latent and an sLSTM's state whole on every model rank),
        an encoder-decoder's cross cache by ``execution_cross_placements``
        (else None), ``specs`` the cache's."""
        dev = self.device if device is None else torch.device(device)
        (full, specs), cross = self._cache_layout(batch, smax, shard_seq)
        if shard_seq and self.cfg.use_mla and self.par.data_size > 1:
            raise NotImplementedError(
                f"{self.cfg.name}: the absorbed decode over a latent cache "
                f"whose sequence is split over the data axes")
        for seg in specs if self.par.data_size > 1 else ():
            for blk in seg:
                spec = next(iter(blk.values()))     # dim 1 is the batch
                if (spec[1] is not None) != self.batch_over_data:
                    raise ValueError(
                        f"cache batch {batch} placed {spec}, but the "
                        f"model's batch_over_data is {self.batch_over_data}")
        def local(tree, tree_specs):
            return _map2(lambda leaf, spec: torch.zeros(
                local_shape(leaf.shape, spec, self.mesh), dtype=leaf.dtype,
                device=dev), tree, tree_specs)
        cache = local(full, specs)
        for seg_cache, seg in zip(cache, self.cfg.segments):
            for blk_cache, blk in zip(seg_cache, seg.blocks):
                if blk.kind in STABILIZER_INIT:     # as init_cache starts
                    blk_cache["m"].fill_(STABILIZER_INIT[blk.kind])
        return cache, None if cross is None else local(*cross), specs

    def _cache_layout(self, batch: int, smax: int, shard_seq: bool):
        """The whole cache's tree on ``meta`` and its placements, and
        the cross cache's (or None), once per shape."""
        key = (batch, smax, shard_seq)
        if key not in self._layouts:
            full, cross = init_cache(self.cfg, batch, smax, device="meta")
            self._layouts[key] = (
                (full, execution_cache_placements(full, self.mesh,
                                                  shard_seq=shard_seq)),
                None if cross is None else (cross, execution_cross_placements(
                    cross, self.mesh, shard_seq=shard_seq)))
        return self._layouts[key]

    def _cache_par(self, state) -> Parallel:
        return self.par.for_cache(state[2])

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                smax: int, shard_seq: bool = False):
        """This rank's prompts into a fresh cache of ``smax`` slots:
        (last-position logits (B,1,V/model), cache state)."""
        tokens = batch["tokens"]
        rows = tokens.shape[0] * (self.par.data_size
                                  if self.batch_over_data else 1)
        return self._prefill(params, batch, self.init_cache(
            rows, smax, shard_seq, tokens.device))


def build_sharded(cfg: ArchConfig, mesh, device=None,
                  batch_over_data: bool = True) -> ShardedModel:
    """A sharded model on ``device`` (default ``cuda``; ``"meta"`` for
    the dry-run when asked for)."""
    return ShardedModel(cfg, mesh, resolve_device(device), batch_over_data)
