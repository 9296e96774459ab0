"""A one-rank stub of a ``DeviceMesh`` and the check that a
``ShardedModel``'s local leaves are the reference's shards, for the
tests of the families it shards. Imports no JAX: the placements are the
port's ``param_placements``, which equal the reference's
``param_pspec`` leaf for leaf (tests/test_torch_sharding.py).
"""

import itertools
import math

import torch

from repro_torch.models import build_model
from repro_torch.models.parallel import ShardedModel
from repro_torch.models.sharding import (
    _FFN_DENSE,
    _FFN_RE,
    _paired,
    _stacked,
    local_shape,
    param_placements,
    path_str,
    resolve,
)


class StubMesh:
    """What ``ShardedModel`` reads of a ``(data, model)`` DeviceMesh, for
    the rank at ``coord``; it has no process groups, so nothing that
    issues a collective runs on it."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data: int, model: int, coord=(0, 0)):
        self.dims, self.coord = (data, model), tuple(coord)

    def size(self, i: int) -> int:
        return self.dims[i]

    def get_coordinate(self):
        return list(self.coord)

    def get_group(self, name):
        return None


def _walk(tree, path=()):
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


def check_local_shapes(cfg, data: int, model: int) -> int:
    """``cfg`` builds a ShardedModel on a ``(data, model)`` stub mesh at
    every rank's coordinates, and each leaf ``init_local`` draws has the
    shape ``local_shape`` gives the reference's spec of that leaf, but
    where the port's layout differs by design: a stacked dense FFN
    weight under the dense rule, a Mamba ``in_proj`` or mLSTM ``up``
    viewed as (D, 2, D_in / model). Its cache builds too. Returns the
    leaves checked."""
    full = build_model(cfg, "meta").init(None)
    ref = param_placements(full, StubMesh(data, model))
    n = 0
    for coord in itertools.product(range(data), range(model)):
        mesh = StubMesh(data, model, coord)
        sharded = ShardedModel(cfg, mesh, torch.device("meta"))
        local = sharded.init_local()
        for path, leaf in _walk(local):
            shape = tuple(_at(full, path).shape)
            spec = _at(ref, path)
            m = _FFN_RE.search(path_str(path))
            if m and _stacked(path) and len(shape) == 3:
                spec = resolve(_FFN_DENSE[m.group(1)], shape, mesh)
            want = local_shape(shape, spec, mesh)
            got = tuple(leaf.shape)
            if _paired(path):
                got = got[:-2] + (got[-2] * got[-1],)
            assert got == want, (path, coord, got, want)
            assert leaf.numel() == math.prod(want)
            n += 1
        cache, cross, _ = sharded.init_cache(4 * data, 32, device="meta")
        assert (cross is not None) == cfg.is_encoder_decoder
        assert all(t.shape[1] == 4 for _, t in _walk(cache))
    return n
