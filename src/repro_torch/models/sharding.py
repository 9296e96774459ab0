"""FSDP x TP placements for the model zoo: the reference's
``repro/models/sharding.py`` rules, per leaf, in the reference's
vocabulary.

Mesh axes: ``("data", "model")`` on one pod, ``("pod", "data", "model")``
on several. Parameters are fully sharded: FSDP over the data axes plus
tensor parallelism over ``model`` on the layer's natural parallel
dimension (attention heads, FFN hidden, experts, vocabulary). A
dimension that does not divide its axis falls back to replication on
that axis, so odd vocabularies and the tiny smoke configs still place.

A placement spec is a tuple with one entry per tensor dimension: an
axis name, a tuple of axis names (the data axes of a multi-pod mesh),
or ``None`` (replicated); ``()`` means replicated whole. That is the
reference's ``PartitionSpec`` as a plain tuple, so ``tuple(ref_spec) ==
port_spec`` compares the two. :func:`to_placements` turns a spec into
``torch.distributed`` ``Shard(d)`` / ``Replicate()`` per mesh dimension.

Rules are path-based (a regex on the flattened parameter path, e.g.
``['segments'][0][0]['core']['wq']``); stacked segment leaves carry a
leading ``repeat`` axis, always replicated: specs align to the TRAILING
dims, with 0 or 1 leading axes.

A mesh is anything with ``axis_names`` and a ``shape`` mapping (the
reference's ``jax.sharding.Mesh``, a stub namespace) or a
``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple

Spec = Tuple[Any, ...]

# (path regex, spec). "fsdp" => mesh data axes; "model" => TP axis.
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / heads / modality projectors
    (r"\['embed'\]$", ("model", "fsdp")),
    (r"\['unembed'\]$", ("fsdp", "model")),
    (r"\['img_proj'\]$", (None, "fsdp")),
    (r"\['encoder'\]\['in_proj'\]$", (None, "fsdp")),
    # attention (3-D head-split weights) + biases
    (r"\['(?:core|cross)'\]\['wq'\]$", ("fsdp", "model", None)),
    (r"\['(?:core|cross)'\]\['w[kv]'\]$", ("fsdp", "model", None)),
    (r"\['(?:core|cross)'\]\['wo'\]$", ("model", None, "fsdp")),
    (r"\['b[qkv]'\]$", ("model", None)),
    # MLA
    (r"\['wq_a'\]$", ("fsdp", None)),
    (r"\['wq_b'\]$", ("fsdp", "model", None)),
    (r"\['wkv_a'\]$", ("fsdp", None)),
    (r"\['wkv_b_[kv]'\]$", (None, "model", None)),
    # MoE router
    (r"\['router'\]$", ("fsdp", None)),
    # mamba
    (r"\['core'\]\['in_proj'\]$", ("fsdp", "model")),
    (r"\['conv_w'\]$", (None, "model")),
    (r"\['w_bc'\]$", ("model", None)),
    (r"\['(?:w_dt|b_dt|d_skip)'\]$", ("model",)),
    (r"\['a_log'\]$", ("model", None)),
    (r"\['out_proj'\]$", ("model", "fsdp")),
    # mlstm
    (r"\['up'\]$", ("fsdp", "model")),
    (r"\['m[qkv]'\]$", ("fsdp", "model")),
    (r"\['w_[if]'\]$", ("model", None)),
    (r"\['b_[if]'\]$", ("model",)),
    (r"\['down'\]$", ("model", "fsdp")),
    # slstm: replicated (the reference's choice: sharding r_h would put an
    # all-reduce inside every step of the sequential recurrence)
    (r"\['(?:w_x|r_h)'\]$", (None, None)),
    (r"\['core'\]\['bias'\]$", (None,)),
    (r"\['core'\]\['proj'\]$", (None, None)),
    # heads
    (r"\['mtp'\]\['proj'\]$", ("fsdp", None)),
)

# dense-vs-MoE FFN weights share names under ['ffn']/['shared']; the MoE
# variants are one rank higher ((E, D, F) with experts over `model`).
_FFN_RE = re.compile(r"\['(?:ffn|shared)'\]\['w([gud])'\]$")
_FFN_DENSE = {"g": ("fsdp", "model"), "u": ("fsdp", "model"),
              "d": ("model", "fsdp")}
_FFN_MOE = {"g": ("model", "fsdp", None), "u": ("model", "fsdp", None),
            "d": ("model", "fsdp", None)}
# the projections whose output is [x | gate] in one axis: Mamba's in_proj
# and mLSTM's up
_PAIRED_RE = re.compile(r"\['core'\]\['(?:in_proj|up)'\]$")
_LATENT_RE = re.compile(r"\['(?:c_kv|k_rope)'\]$")

MODEL = "model"


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(axis names, {name: size}) of a reference mesh, a stub or a
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), {n: mesh.size(i) for i, n in enumerate(names)}
    return tuple(mesh.axis_names), {n: int(mesh.shape[n])
                                    for n in mesh.axis_names}


def _axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    names, sizes = mesh_axes(mesh)
    return tuple(n for n in names if n != MODEL), sizes


def data_entry(fsdp_axes: Sequence[str]):
    """The spec entry of the data axes: one name, or a tuple of them."""
    return tuple(fsdp_axes) if len(fsdp_axes) > 1 else fsdp_axes[0]


def _sizes(mesh) -> Tuple[Tuple[str, ...], int, int]:
    fsdp_axes, sizes = _axes(mesh)
    fsdp_size = 1
    for a in fsdp_axes:
        fsdp_size *= sizes[a]
    return fsdp_axes, fsdp_size, sizes[MODEL]


def path_str(path: Sequence[Any]) -> str:
    """The reference's ``_path_str``: ``['key']`` per dict key, ``[i]``
    per tuple index, joined."""
    return "".join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]"
                   for p in path)


def _map_with_path(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def resolve(spec: Tuple[Optional[str], ...], shape: Tuple[int, ...],
            mesh) -> Spec:
    """Align ``spec`` to the trailing dims of ``shape`` (0-1 leading
    repeat axes allowed) with per-dim divisibility fallbacks; ``()``
    when the ranks do not align."""
    fsdp_axes, fsdp_size, model_size = _sizes(mesh)
    n_lead = len(shape) - len(spec)
    if n_lead not in (0, 1):
        return ()
    out: list = [None] * n_lead
    for dim_size, s in zip(shape[n_lead:], spec):
        if s == "fsdp" and dim_size % fsdp_size == 0:
            out.append(data_entry(fsdp_axes))
        elif s == MODEL and dim_size % model_size == 0:
            out.append(MODEL)
        else:
            out.append(None)
    return tuple(out)


def _param_spec(path, shape: Tuple[int, ...], mesh) -> Spec:
    ps = path_str(path)
    m = _FFN_RE.search(ps)
    if m:
        which = m.group(1)
        specs = ((_FFN_MOE[which],) if len(shape) >= 3 else ()) + \
            (_FFN_DENSE[which],)
        for spec in specs:
            if len(shape) - len(spec) in (0, 1):
                # rank 3 is a stacked dense FFN (repeat, D, F), an
                # unstacked expert stack (E, D, F) or a stacked shared
                # expert; the shared expert is always dense-shaped
                if len(spec) == 3 and len(shape) == 3 and "shared" in ps:
                    continue
                return resolve(spec, shape, mesh)
        return ()
    for pat, spec in _RULES:
        if re.search(pat, ps):
            return resolve(spec, shape, mesh)
    return ()      # replicated: norm scales, small vectors


def param_placements(params: Any, mesh) -> Any:
    """Per-leaf specs of a parameter tree (tensors, meta tensors, or
    anything with ``.shape``), the tree's structure kept: the
    reference's ``param_pspec`` exactly.

    That includes its treatment of a stacked dense FFN weight (repeat,
    D, F): rank 3 takes the MoE branch first, so the REPEAT (layer) axis
    goes over ``model``, D over the data axes and F is replicated, where
    the reference's docstring and comments name the FFN hidden as the
    TP dimension. :func:`execution_placements` is the layout the port
    runs."""
    return _map_with_path(
        lambda path, leaf: _param_spec(path, tuple(leaf.shape), mesh),
        params)


def _paired(path) -> bool:
    return bool(_PAIRED_RE.search(path_str(path)))


def _stacked(path) -> bool:
    """A leaf of a decoder or encoder segment: a leading repeat axis."""
    return path[0] == "segments" or tuple(path[:2]) == ("encoder",
                                                        "segments")


def execution_view(params: Any) -> Any:
    """The tree the port runs under a mesh: the reference's, but each
    Mamba ``in_proj`` and mLSTM ``up`` (..., D, 2 D_in) viewed as (...,
    D, 2, D_in), so that a split of D_in over ``model`` gives every rank
    the same channels of x and of the gate z (the blocks split the
    projection's output in halves). Views of the same storage; ``meta``
    leaves too."""
    return _map_with_path(
        lambda path, leaf: leaf.reshape(*leaf.shape[:-1], 2,
                                        leaf.shape[-1] // 2)
        if _paired(path) else leaf, params)


def execution_placements(params: Any, mesh) -> Any:
    """The layout :mod:`repro_torch.models.parallel` runs, as specs of
    ``execution_view(params)`` (``params`` in the reference's shapes):
    the reference's placements, with two differences by design.

    * A stacked dense FFN weight (repeat, D, F), of the decoder or of
      whisper's encoder, takes the dense rule the reference documents
      (after the repeat axis: D over the data axes, the FFN hidden over
      ``model``) where the reference's function takes its MoE branch
      (the layer axis over ``model``): column- and row-parallel
      products instead of each layer's weights living on one model
      rank. Where the layers divide ``model`` a device holds the
      reference's bytes; where they do not (DeepSeek-V3's 3 dense
      layers, Jamba's 9 periods, whisper's 12 and pixtral's 40 on 16,
      any one-layer config) the reference replicates the weight over
      ``model`` and the port holds a ``1 / model`` slice of it.
    * A Mamba ``in_proj`` or an mLSTM ``up``, viewed as (D, 2, D_in),
      has D over the data axes and D_in over ``model``: the reference's
      ``("fsdp", "model")`` cuts the concatenated [x | z] axis in one
      piece, which on ``model`` 2 gives rank 0 every x channel and rank 1
      every z channel. The bytes a device holds are the reference's."""
    def spec(path, leaf):
        shape = tuple(leaf.shape)
        m = _FFN_RE.search(path_str(path))
        if m and _stacked(path) and len(shape) == 3:
            return resolve(_FFN_DENSE[m.group(1)], shape, mesh)
        if _paired(path):
            return resolve(("fsdp", None, MODEL),
                           shape[:-1] + (2, shape[-1] // 2), mesh)
        return _param_spec(path, shape, mesh)

    return _map_with_path(spec, params)


def batch_placements(batch: Any, mesh) -> Any:
    """The batch dimension over the data axes when it divides."""
    fsdp_axes, fsdp_size, _ = _sizes(mesh)

    def assign(_, leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 1 and shape[0] % fsdp_size == 0:
            return (data_entry(fsdp_axes),) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return _map_with_path(assign, batch)


def cache_placements(cache: Any, mesh, shard_seq: bool = False) -> Any:
    """Decode-cache specs: batch over the data axes; KV heads, the MLA
    latent or state channels over ``model`` where they divide. With
    ``shard_seq`` (long_500k, batch 1) the cache's sequence goes over
    the data axes instead. A GQA cache whose KV heads do not divide
    ``model`` puts its SEQUENCE over ``model`` (qwen2-72b's 8 KV heads
    on model 16, granite-34b's one): each model rank holds a slice of
    the context."""
    return _cache_specs(cache, mesh, shard_seq, latent_over_model=True)


def _cache_specs(cache: Any, mesh, shard_seq: bool,
                 latent_over_model: bool) -> Any:
    fsdp_axes, fsdp_size, model_size = _sizes(mesh)
    data = data_entry(fsdp_axes)

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        ps = path_str(path)
        spec: list = [None] * len(shape)
        # leading repeat axis replicated; dim 1 is batch
        if len(shape) >= 2 and shape[1] % fsdp_size == 0 and not shard_seq:
            spec[1] = data
        if re.search(r"\['(?:k|v|k_rope|c_kv)'\]$", ps) and len(shape) >= 4:
            if shard_seq and shape[2] % fsdp_size == 0:
                spec[2] = data
            split = latent_over_model or not _LATENT_RE.search(ps)
            if split and shape[3] % model_size == 0:
                spec[3] = MODEL
            elif split and spec[2] is None and shape[2] % model_size == 0:
                spec[2] = MODEL
        elif re.search(r"\['(?:h|conv|C|n)'\]$", ps) and len(shape) >= 3:
            ch_dim = 2 if not re.search(r"\['conv'\]$", ps) else 3
            if ch_dim < len(shape) and shape[ch_dim] % model_size == 0:
                spec[ch_dim] = MODEL
        return tuple(spec)

    return _map_with_path(assign, cache)


def execution_cache_placements(cache: Any, mesh,
                               shard_seq: bool = False) -> Any:
    """The cache layout the port runs: :func:`cache_placements`, with
    three differences by design.

    * MLA's latent cache (``c_kv``, ``k_rope``) is replicated over
      ``model``. The absorbed decode contracts each of a rank's query
      heads with the whole latent, so a latent split over ``model``
      would be all-gathered every step; replicated, each model rank
      holds ``kv_lora + qk_rope`` values a token a layer (DeepSeek-V3:
      576, 1152 bytes in bf16), ``model`` times the reference's shard.
    * An mLSTM's stabilizer ``m`` (B, H) keeps this rank's heads, as its
      ``C`` and ``n`` do; the reference's rule misses the name and
      replicates it.
    * An sLSTM's four states are whole on every model rank, where the
      reference splits ``h`` and ``n`` over ``model``: every step of the
      recurrence multiplies the whole ``h`` by the (replicated) ``r_h``,
      so a split ``h`` would be all-gathered every token."""
    specs = _cache_specs(cache, mesh, shard_seq, latent_over_model=False)
    return tuple(tuple(_run_block_cache(blk) for blk in seg)
                 for seg in specs)


def _run_block_cache(spec: Dict[str, Spec]) -> Dict[str, Spec]:
    if "C" in spec:                         # mLSTM
        return {**spec, "m": spec["C"][:3]}
    if "c" in spec:                         # sLSTM
        return {k: tuple(None if e == MODEL else e for e in s)
                for k, s in spec.items()}
    return spec


def execution_cross_placements(cross: Any, mesh,
                               shard_seq: bool = False) -> Any:
    """The layout the port runs for an encoder-decoder's cross cache
    (``(repeat, B, F, KV, hd)`` a segment, from ``init_cache``'s second
    element): the reference's ``cache_pspec`` of it, but the frames are
    never split. The reference puts them over ``model`` where the KV
    heads do not divide it (and over the data axes with ``shard_seq``);
    the port then holds every frame, as the query heads are then
    replicated and every rank attends over all of them."""
    return tuple({k: tuple(None if d == 2 else e for d, e in enumerate(s))
                  for k, s in seg.items()}
                 for seg in cache_placements(cross, mesh, shard_seq))


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Spec, mesh) -> list:
    """``Shard(d)`` / ``Replicate()`` per mesh dimension, in the mesh's
    axis order: the ``torch.distributed.tensor`` form of ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    names, _ = mesh_axes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for axis in entry_axes(entry):
            out[names.index(axis)] = Shard(d)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor placed by
    ``spec``."""
    _, sizes = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in entry_axes(entry):
            out[d] //= sizes[axis]
    return tuple(out)


def local_slices(shape: Sequence[int], spec: Spec, mesh,
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The index of the shard of the rank at mesh coordinates ``coords``
    ({axis: index}); a dim over several axes is split in their order,
    the first axis outermost."""
    _, sizes = mesh_axes(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        idx, parts = 0, 1
        for axis in entry_axes(entry):
            idx = idx * sizes[axis] + coords[axis]
            parts *= sizes[axis]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)
