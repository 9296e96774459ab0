"""The port's placements (``repro_torch.models.sharding``) against the
reference's ``param_pspec``, ``batch_pspec`` and ``cache_pspec``, leaf by
leaf, with ``==``.

The eight configs the port builds, at full published size: the JAX
trees come from ``jax.eval_shape`` of the reference's ``init`` /
``init_cache`` and the port's from ``init`` / ``init_cache`` on the
``meta`` device, so nothing is allocated. The meshes are stub
namespaces with ``axis_names`` and ``shape`` (the reference's rules
read nothing else): ``(16, 16)``, ``(2, 16, 16)``, ``(1, 4)``, ``(2, 2)``
and ``(1, 1)``. Exact equality: the specs are discrete.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch.shapes import dryrun_config as jax_dryrun_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.kvcache import init_cache as jax_init_cache  # noqa: E402
from repro.models.sharding import (  # noqa: E402
    batch_pspec,
    cache_pspec,
    param_pspec,
)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.shapes import SHAPES, dryrun_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.kvcache import init_cache  # noqa: E402
from repro_torch.models.parallel import shard_params  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    batch_placements,
    cache_placements,
    local_shape,
    local_slices,
    param_placements,
    to_placements,
)

BUILT = ("llama3.2-1b", "phi3-mini-3.8b", "qwen2-72b", "granite-34b",
         "granite-moe-1b-a400m", "deepseek-v3-671b", "jamba-1.5-large-398b",
         "xlstm-125m")
MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "1x4": (("data", "model"), (1, 4)),
    "2x2": (("data", "model"), (2, 2)),
    "1x1": (("data", "model"), (1, 1)),
}


def _stub(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))


def _jax_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return [("".join(str(p) for p in path), tuple(s)) for path, s in flat]


def _port_flat(tree, path=""):
    """(path, spec) in jax.tree_util's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_flat(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and tree and not _is_spec(tree):
        return [x for i, t in enumerate(tree)
                for x in _port_flat(t, f"{path}[{i}]")]
    return [(path, tree)]


def _is_spec(t):
    return all(e is None or isinstance(e, (str, tuple)) and
               (not isinstance(e, tuple) or all(isinstance(a, str)
                                                for a in e)) for e in t)


_TREES = {}


def _trees(arch, vocab_pad=False):
    key = (arch, vocab_pad)
    if key not in _TREES:
        jcfg, cfg = jax_get_arch(arch), get_arch(arch)
        if vocab_pad:
            jcfg, _ = jax_dryrun_config(jcfg, JAX_SHAPES["train_4k"], 16)
            cfg, _ = dryrun_config(cfg, SHAPES["train_4k"], 16)
        jm = jax_build_model(jcfg)
        jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        tp = build_model(cfg, "meta").init(None)
        _TREES[key] = (jcfg, cfg, jp, tp)
    return _TREES[key]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", BUILT)
def test_param_placements_equal_the_reference_at_full_size(arch, mesh):
    _, _, jp, tp = _trees(arch)
    m = _stub(mesh)
    want = _jax_flat(param_pspec(jp, m))
    got = _port_flat(param_placements(tp, m))
    assert len(got) == len(want)
    assert got == want


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama3.2-1b"])
def test_padded_vocabulary_shards_as_the_reference(arch, mesh):
    """dryrun_config pads granite-moe's 49155 to 49168, a multiple of 16:
    its embedding then goes over `model` in both packages."""
    jcfg, cfg, jp, tp = _trees(arch, vocab_pad=True)
    assert cfg.vocab_size == jcfg.vocab_size and cfg.vocab_size % 16 == 0
    m = _stub(mesh)
    got = dict(_port_flat(param_placements(tp, m)))
    assert _port_flat(param_placements(tp, m)) == \
        _jax_flat(param_pspec(jp, m))
    assert got["['embed']"][0] == "model"


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", BUILT)
def test_cache_placements_equal_the_reference(arch, mesh, shape):
    """decode_32k (batch 128 over data) and long_500k (batch 1, the
    sequence over data with ``shard_seq``), at full size."""
    spec = SHAPES[shape]
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    jc = jax.eval_shape(lambda: jax_init_cache(jcfg, spec.batch, spec.seq))
    tc, _ = init_cache(cfg, spec.batch, spec.seq, device="meta")
    m = _stub(mesh)
    shard_seq = spec.batch == 1
    want = _jax_flat(cache_pspec(jc[0], m, shard_seq=shard_seq))
    got = _port_flat(cache_placements(tc, m, shard_seq=shard_seq))
    assert got == want


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", MESHES)
def test_cross_cache_placements_equal_the_reference(mesh, shape):
    """whisper-small's cross cache (the second element of init_cache),
    which the reference's dry-run places with the same cache_pspec."""
    spec = SHAPES[shape]
    jcfg, cfg = jax_get_arch("whisper-small"), get_arch("whisper-small")
    jc = jax.eval_shape(lambda: jax_init_cache(jcfg, spec.batch, spec.seq))
    _, cross = init_cache(cfg, spec.batch, spec.seq, device="meta")
    m = _stub(mesh)
    shard_seq = spec.batch == 1
    assert _port_flat(cache_placements(cross, m, shard_seq=shard_seq)) == \
        _jax_flat(cache_pspec(jc[1], m, shard_seq=shard_seq))


def test_qwen2_cache_puts_the_sequence_over_model_16():
    """qwen2-72b's 8 KV heads do not divide model 16: the reference puts
    the SEQUENCE over `model` (sharding.py:262-271); so does the port.
    On model 4 the heads divide and go over `model`."""
    cfg = get_arch("qwen2-72b")
    tc, _ = init_cache(cfg, 128, 32768, device="meta")
    got = cache_placements(tc, _stub("16x16"))
    assert got[0][0]["k"] == (None, "data", "model", None, None)
    got = cache_placements(tc, _stub("1x4"))
    assert got[0][0]["k"] == (None, "data", None, "model", None)
    # granite-34b's single KV head: the sequence on every model size
    tc, _ = init_cache(get_arch("granite-34b"), 8, 1024, device="meta")
    assert cache_placements(tc, _stub("2x2"))[0][0]["v"] == \
        (None, "data", "model", None, None)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("batch", [1, 2, 7, 32, 128, 256])
def test_batch_placements_equal_the_reference(mesh, batch):
    m = _stub(mesh)
    jb = {"tokens": jax.ShapeDtypeStruct((batch, 64), np.int32),
          "loss_mask": jax.ShapeDtypeStruct((batch, 64), np.float32),
          "pos": jax.ShapeDtypeStruct((), np.int32)}
    tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
    want = dict(_jax_flat(batch_pspec(jb, m)))
    got = batch_placements(tb, m)
    assert {f"[{k!r}]": v for k, v in got.items()} == want


def test_to_placements_and_local_shards():
    """A spec as Shard/Replicate per mesh dim; shard_params cuts the
    slice each spec names, and the shards tile the leaf."""
    from torch.distributed.tensor import Replicate, Shard
    m = _stub("2x16x16")
    assert to_placements((("pod", "data"), "model", None), m) == \
        [Shard(0), Shard(0), Shard(1)]
    assert to_placements((None, "model"), m) == \
        [Replicate(), Replicate(), Shard(1)]
    assert to_placements((), m) == [Replicate()] * 3
    assert local_shape((64, 32, 8), (("pod", "data"), "model", None), m) \
        == (2, 2, 8)

    m = _stub("2x2")
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), d_model=64,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              d_ff=128, vocab_size=256)
    full = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    wq = full["segments"][0][0]["core"]["wq"]          # (16, 64, 4, 16)
    pieces = {}
    for d in range(2):
        for r in range(2):
            coords = {"data": d, "model": r}
            local = shard_params(full, m, coords)
            got = local["segments"][0][0]["core"]["wq"]
            assert got.shape == (16, 32, 2, 16) and got.is_contiguous()
            idx = local_slices(wq.shape, (None, "data", "model", None), m,
                               coords)
            torch.testing.assert_close(got, wq[idx], rtol=0, atol=0)
            pieces[(d, r)] = got
    rows = [torch.cat([pieces[(d, 0)], pieces[(d, 1)]], 2) for d in range(2)]
    torch.testing.assert_close(torch.cat(rows, 1), wq, rtol=0, atol=0)



def _walk(tree, path=()):
    """(path, leaf) of a parameter tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _walk(t, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "1x4"])
@pytest.mark.parametrize("arch", BUILT)
def test_execution_layout_differs_only_at_stacked_dense_ffns(arch, mesh):
    """The layout the port runs is the reference's placements except at
    two by-design differences. A stacked dense FFN weight (repeat, D, F):
    there the reference's function puts the layer axis over `model`
    (rank 3 takes its MoE branch), or replicates the weight where the
    layers do not divide `model`, and the port runs the dense rule the
    reference documents (D over the data axes, the FFN hidden over
    `model`). A Mamba in_proj or an mLSTM up (repeat, D, 2 D_in) runs
    as (repeat, D, 2, D_in) with D_in over `model`, so that a rank's x
    and z channels match, where the reference cuts the concatenated
    axis in one piece. Whisper's encoder FFN is a stacked dense FFN
    too."""
    from repro_torch.models.sharding import execution_placements
    _, _, _, tp = _trees(arch)
    m = _stub(mesh)
    ref, run = param_placements(tp, m), execution_placements(tp, m)
    data = ("pod", "data") if mesh == "2x16x16" else "data"
    n_data = 32 if mesh == "2x16x16" else m.shape["data"]
    n_model = m.shape["model"]
    changed = 0
    for path, leaf in _walk(tp):
        got, want = _at(run, path), _at(ref, path)
        stacked = path[0] == "segments" or path[:2] == ("encoder",
                                                        "segments")
        if stacked and path[-2] in ("ffn", "shared") and \
                path[-1] in ("wg", "wu", "wd") and leaf.dim() == 3:
            r, a, b = leaf.shape
            if path[-1] == "wd":           # (repeat, F, D)
                want = (None, "model" if a % n_model == 0 else None,
                        data if b % n_data == 0 else None)
            else:                          # (repeat, D, F)
                want = (None, data if a % n_data == 0 else None,
                        "model" if b % n_model == 0 else None)
        if path[-2:] in (("core", "in_proj"), ("core", "up")):
            r, d, e = leaf.shape           # (repeat, D, 2 D_in)
            want = (None, data if d % n_data == 0 else None, None,
                    "model" if (e // 2) % n_model == 0 else None)
        changed += got != _at(ref, path)
        assert got == want, path
    if get_arch(arch).family in ("dense", "hybrid", "ssm", "encdec",
                                 "vlm"):
        assert changed > 0


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "1x4", "2x2"])
@pytest.mark.parametrize("shard_seq", [False, True])
def test_execution_cache_holds_the_recurrent_states_as_the_cells_run(
        mesh, shard_seq):
    """xlstm-125m's cache as the port runs it: the reference's
    placements, but an mLSTM's stabilizer m keeps the heads of its C
    and n (the reference's rule misses the name), and an sLSTM's four
    states are whole over `model` (the reference splits h and n there).
    whisper-small's cross cache keeps the reference's but never splits
    its frames (with shard_seq the reference puts them over the data
    axes)."""
    from repro_torch.models.sharding import (execution_cache_placements,
                                             execution_cross_placements)
    m = _stub(mesh)
    batch = 1 if shard_seq else 128
    tc, _ = init_cache(get_arch("xlstm-125m"), batch, 4096, device="meta")
    ref = cache_placements(tc, m, shard_seq=shard_seq)
    run = execution_cache_placements(tc, m, shard_seq=shard_seq)
    heads_split = 4 % m.shape["model"] == 0
    for seg_ref, seg_run in zip(ref, run):
        for blk_ref, blk_run in zip(seg_ref, seg_run):
            assert blk_ref.keys() == blk_run.keys()
            if "C" in blk_ref:                          # mLSTM
                assert blk_run["m"] == blk_ref["C"][:3]
                assert blk_run["m"][2] == ("model" if heads_split
                                           else None)
                assert {k: blk_run[k] for k in "Cn"} == \
                    {k: blk_ref[k] for k in "Cn"}
            else:                                       # sLSTM
                for k, spec in blk_ref.items():
                    assert blk_run[k] == tuple(
                        None if e == "model" else e for e in spec), k
                assert blk_ref["h"][2] == "model"
    _, cross = init_cache(get_arch("whisper-small"), batch, 4096,
                          device="meta")
    ref = cache_placements(cross, m, shard_seq=shard_seq)
    run = execution_cross_placements(cross, m, shard_seq=shard_seq)
    for seg_ref, seg_run in zip(ref, run):
        for k in ("k", "v"):
            want = list(seg_ref[k])
            want[2] = None
            assert seg_run[k] == tuple(want)
            assert seg_run[k][3] == ("model" if 12 % m.shape["model"] == 0
                                     else None)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "1x4", "2x2"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-1.5-large-398b",
                                  "qwen2-72b"])
def test_execution_cache_keeps_the_latent_whole_over_model(arch, mesh):
    """The cache the port runs is the reference's placements, but MLA's
    latent (c_kv, k_rope) is replicated over `model`: the absorbed
    decode contracts every local head with the whole latent. The data
    axes, the KV heads and the Mamba state keep the reference's."""
    from repro_torch.models.sharding import execution_cache_placements
    cfg = get_arch(arch)
    m = _stub(mesh)
    for shape, shard_seq in (((128, 1024), False), ((1, 4096), True)):
        tc, _ = init_cache(cfg, *shape, device="meta")
        ref = dict(_port_flat(cache_placements(tc, m, shard_seq=shard_seq)))
        run = dict(_port_flat(execution_cache_placements(
            tc, m, shard_seq=shard_seq)))
        assert run.keys() == ref.keys()
        for path, spec in ref.items():
            if path.endswith(("['c_kv']", "['k_rope']")):
                assert "model" in spec
                spec = tuple(None if e == "model" else e for e in spec)
            assert run[path] == spec, path


def test_mamba_shards_hold_matching_x_and_z_channels():
    """Each rank's local in_proj, read as the block reads it ((D, 2
    D_in / model), split in halves), gives x and the gate z of the same
    channels, the channels its conv_w, dt, A and skip rows and its
    carried state hold; and ShardedModel.init_local's deterministic
    leaves (A, dt's weight and bias, the skip, the norm scales) equal
    the rows of Model.init's."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.parallel import ShardedModel
    cfg = get_smoke("jamba-1.5-large-398b")
    full = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    d_in = cfg.d_model * cfg.mamba_expand
    for mesh in ("1x4", "2x2"):
        m = _stub(mesh)
        n_model, n_data = m.shape["model"], m.shape["data"]
        c = d_in // n_model
        for r in range(n_model):
            coords = {"data": n_data - 1, "model": r}
            local = shard_params(full, m, coords)
            for bi, blk in enumerate(cfg.segments[0].blocks):
                if blk.kind != "mamba":
                    continue
                want, got = full["segments"][0][bi]["core"], \
                    local["segments"][0][bi]["core"]
                w = got["in_proj"]                   # (1, D / data, 2, c)
                assert w.shape == (1, cfg.d_model // n_data, 2, c)
                xs, z = w.reshape(1, w.shape[1], -1).chunk(2, dim=-1)
                rows = slice((n_data - 1) * w.shape[1], n_data * w.shape[1])
                chans = slice(r * c, (r + 1) * c)
                ref_in = want["in_proj"][:, rows]
                assert torch.equal(xs, ref_in[..., :d_in][..., chans])
                assert torch.equal(z, ref_in[..., d_in:][..., chans])
                for key in ("w_dt", "b_dt", "d_skip", "a_log"):
                    assert torch.equal(got[key], want[key][:, chans]), key
                assert torch.equal(got["conv_w"], want["conv_w"][..., chans])

    class Mesh:         # a (2, 2) DeviceMesh's surface, for one rank
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 2

        def get_coordinate(self):
            return [1, 1]

        def get_group(self, name):
            return None

    model = ShardedModel(cfg, Mesh(), torch.device("cpu"))
    local = model.init_local(1)
    det = ("w_dt", "b_dt", "d_skip", "a_log", "scale")
    n = 0
    for path, leaf in _walk(local):
        if path[-1] in det:
            want = _at(full, path)
            idx = local_slices(want.shape, _at(model.specs, path),
                               _stub("2x2"), {"data": 1, "model": 1})
            assert torch.equal(leaf, want[idx]), path
            n += 1
    assert n == 4 * 7 + 2 * 8 + 1         # 7 Mamba layers, 16 norms, final


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_init_local_gives_ranks_that_hold_one_shard_the_same_values(mesh):
    """ShardedModel.init_local from one seed on every rank: the ranks
    that hold the same shard of a leaf (replicated over ``model``, or a
    copy over ``data``) draw the same values, and two shards of a leaf
    split over an axis differ. Seeded by rank, as the card's whole-model
    runs once drew, DeepSeek's replicated router differed from rank to
    rank, and so did the loss each rank computed. Every leaf is checked
    at every rank of the mesh, DeepSeek's smoke config with MTP."""
    from _torch_shards import StubMesh
    from repro_torch.configs import get_smoke
    from repro_torch.models.parallel import ShardedModel
    from repro_torch.models.sharding import entry_axes
    cfg = get_smoke("deepseek-v3-671b")
    data, model = mesh
    ranks = {}
    for coord in ((d, m) for d in range(data) for m in range(model)):
        sharded = ShardedModel(cfg, StubMesh(data, model, coord),
                               torch.device("cpu"))
        ranks[coord] = (dict(_walk(sharded.init_local(7))), sharded.specs)
    same = split = 0
    ref_leaves, specs = ranks[(0, 0)]
    for path, leaf in ref_leaves.items():
        axes = {a for entry in _at(specs, path) for a in entry_axes(entry)}
        for (d, m), (leaves, _) in ranks.items():
            if (d, m) == (0, 0):
                continue
            moved = ({"data"} if d else set()) | ({"model"} if m else set())
            if moved & axes:
                split += not torch.equal(leaves[path], ref_leaves[path])
            else:
                assert torch.equal(leaves[path], ref_leaves[path]), path
                same += 1
    assert same and split
    # the router is replicated over model, the experts split over it
    moe = ("segments", 1, 0, "ffn")
    for (d, m), (leaves, _) in ranks.items():
        if not d:
            assert torch.equal(leaves[moe + ("router",)],
                               ref_leaves[moe + ("router",)])
        if m:
            assert not torch.equal(leaves[moe + ("wg",)],
                                   ref_leaves[moe + ("wg",)])


def test_mla_decode_over_a_sequence_split_latent_cache_raises():
    """MLA's absorbed decode over a latent cache whose sequence is split
    over the data axes (shard_seq with more than one data rank) is not
    implemented: the cache refuses that layout before any decode, and
    takes it on one data rank. No dry-run shape reaches it (DeepSeek
    has no long-context variant)."""
    from _torch_shards import StubMesh
    from repro_torch.configs import get_smoke
    from repro_torch.models.parallel import ShardedModel
    cfg = get_smoke("deepseek-v3-671b")
    model = ShardedModel(cfg, StubMesh(2, 2), torch.device("meta"),
                         batch_over_data=False)
    with pytest.raises(NotImplementedError, match="sequence is split"):
        model.init_cache(1, 64, shard_seq=True, device="meta")
    model = ShardedModel(cfg, StubMesh(1, 2), torch.device("meta"),
                         batch_over_data=False)
    cache, _, specs = model.init_cache(1, 64, shard_seq=True, device="meta")
    assert cache[0][0]["c_kv"].shape == (1, 1, 64, cfg.kv_lora_rank)
