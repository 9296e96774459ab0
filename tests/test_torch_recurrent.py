"""xLSTM's recurrent decode in the port against the JAX reference: the
mLSTM and sLSTM cells with carried state, ``Model.prefill`` and greedy
``Model.decode_step`` of the smoke xlstm-125m, and every leaf of the
recurrent cache.

Inputs are made with numpy from a seed; parameters come from the JAX
package's ``init`` through ``params_from_numpy``. Tolerances: logits and
cache leaves within 1e-4 (atol and rtol, the port's model tolerance: the
frameworks sum in other orders), greedy tokens equal, and the port's own
decode against its forward at the reference's decode-vs-forward
tolerance (5e-4 / 1e-3, tests/test_models_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model, kvcache  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from _torch_shards import check_local_shapes  # noqa: E402

ARCH = "xlstm-125m"
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    """(JAX model, JAX params, jitted prefill and decode_step, port
    model, port params), built once."""
    jmodel = jax_build_model(jax_get_smoke(ARCH))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_smoke(ARCH), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return (jmodel, jparams, jax.jit(jmodel.prefill, static_argnums=2),
            jax.jit(jmodel.decode_step), model, params)


def _close(got: torch.Tensor, exp) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **MODEL_TOL)


def _close_cache(state, jstate) -> None:
    assert state[1] is None and jstate[1] is None
    got, exp = jax.tree_util.tree_flatten_with_path(
        (state[0],))[0], jax.tree_util.tree_flatten_with_path(
        (jax.tree.map(np.asarray, jstate[0]),))[0]
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, t), (_, a) in zip(got, exp):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
        np.testing.assert_allclose(t.numpy(), a, **MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


# -------------------------------------------------------------------- cells

def _cell_inputs(cfg, kind, seed, b, s):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    jp = (jax_layers.init_mlstm if kind == "mlstm" else
          jax_layers.init_slstm)(jax.random.PRNGKey(seed),
                                 jax_get_smoke(ARCH))
    state = kvcache.init_cache(cfg, b, 8, device="cpu")[0][0][
        0 if kind == "mlstm" else 3]
    # a carried state from somewhere along a sequence: the layer-0 view
    state = {k: torch.from_numpy(rng.standard_normal(
        tuple(v.shape[1:]), dtype=np.float32) * (0.5 if k != "m" else 2.0))
        for k, v in state.items()}
    return x, jp, state


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("s", [1, 5, 128])
def test_cells_continue_from_a_state_like_the_reference(kind, s):
    """From a random carried state, over one step, a ragged chunk and
    two chunks of 64: the output, and the final state written into the
    given tensors in place."""
    cfg = get_smoke(ARCH)
    x, jp, state = _cell_inputs(cfg, kind, 3, 2, s)
    fn = {"mlstm": (L.mlstm_block, jax_layers.mlstm_block),
          "slstm": (L.slstm_block, jax_layers.slstm_block)}[kind]
    exp, jstate = fn[1](jp, jax_get_smoke(ARCH), jnp.asarray(x),
                        {k: jnp.asarray(v.numpy()) for k, v in
                         state.items()})
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    got = fn[0](params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), cfg,
                torch.from_numpy(x), state)
    _close(got, exp)
    assert {k: v.data_ptr() for k, v in state.items()} == ptrs
    for k, v in state.items():
        _close(v, jstate[k])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cells_from_the_initial_state_equal_the_stateless_cells(kind):
    """The scoring path (no state) is what it was: from init_cache's
    initial state a cell gives the stateless output bit for bit."""
    cfg = get_smoke(ARCH)
    x, jp, _ = _cell_inputs(cfg, kind, 4, 2, 128)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    fn = L.mlstm_block if kind == "mlstm" else L.slstm_block
    init = kvcache.init_cache(cfg, 2, 8, device="cpu")[0][0][
        0 if kind == "mlstm" else 3]
    state = {k: v[0] for k, v in init.items()}
    fresh = {k: v.clone() for k, v in state.items()}
    x = torch.from_numpy(x)
    assert torch.equal(fn(params, cfg, x, state), fn(params, cfg, x))
    assert all(not torch.equal(v, fresh[k]) for k, v in state.items())


# -------------------------------------------------------------------- model

@pytest.mark.parametrize("prompt,steps", [
    (100, 6),      # one mLSTM chunk of 100 (not a multiple of 64)
    (128, 6),      # two chunks of 64: the state carried between them
])
def test_prefill_and_greedy_decode_match_jax(built, prompt, steps):
    _, jparams, jprefill, jstep, model, params = built
    tokens = np.random.default_rng(prompt).integers(
        0, model.cfg.vocab_size, (2, prompt)).astype(np.int32)
    exp, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)},
                           prompt + steps)
    got, state = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               prompt + steps)
    assert got.shape == (2, 1, model.cfg.vocab_size)
    _close(got, exp)
    _close_cache(state, jstate)
    for i in range(steps):
        jtok = jnp.argmax(exp[:, -1:], axis=-1).astype(jnp.int32)
        tok = got[:, -1:].argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        exp, jstate = jstep(jparams, jtok, jnp.int32(prompt + i), jstate)
        got, state = model.decode_step(params, tok, prompt + i, state)
        _close(got, exp)
        _close_cache(state, jstate)


def test_decode_continues_from_a_jax_prefill_cache(built):
    _, jparams, jprefill, jstep, model, params = built
    tokens = np.random.default_rng(9).integers(
        0, model.cfg.vocab_size, (2, 100)).astype(np.int32)
    _, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, 106)
    state = params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tok = np.array([[3], [5]], np.int32)
    exp, jnext = jstep(jparams, jnp.asarray(tok), jnp.int32(100), jstate)
    got, state = model.decode_step(params, torch.from_numpy(tok), 100, state)
    _close(got, exp)
    _close_cache(state, jnext)


def test_decode_matches_the_ports_forward(built):
    _, _, _, _, model, params = built
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (2, 70)))
    full, _ = model.forward(params, {"tokens": tokens})
    got, state = model.prefill(params, {"tokens": tokens[:, :64]}, 70)
    torch.testing.assert_close(got[:, 0], full[:, 63], atol=5e-4, rtol=1e-3)
    for i in range(64, 70):
        got, state = model.decode_step(params, tokens[:, i:i + 1], i, state)
        torch.testing.assert_close(got[:, 0], full[:, i], atol=5e-4,
                                   rtol=1e-3)


def test_decode_writes_the_stacked_state_in_place(built):
    """Each layer's state is a view of its segment's stacked tensor: a
    step writes through the view, and the state tree is the one passed
    in."""
    _, _, _, _, model, params = built
    state = model.init_cache(2, 8, "cpu")
    leaves = jax.tree.leaves(state[0])
    ptrs = [t.data_ptr() for t in leaves]
    before = [t.clone() for t in leaves]
    _, out = model.decode_step(params, torch.tensor([[1], [2]]), 0, state)
    assert out is state
    assert [t.data_ptr() for t in jax.tree.leaves(out[0])] == ptrs
    assert all(not torch.equal(t, b) for t, b in zip(leaves, before))


def test_a_mesh_still_refuses_xlstm():
    """Once refused under a mesh, xLSTM builds a ShardedModel on a (1, 2)
    stub mesh whose local leaves are the reference's shards (its parity
    over gloo: tests/test_torch_parallel.py)."""
    assert check_local_shapes(get_smoke(ARCH), 1, 2) > 0
