"""The encoder-decoder (whisper-small) and image (pixtral-12b) models of
the port against the JAX reference, at their smoke configs: the layers
they add (sinusoidal positions, cross-attention), ``Model.init``'s tree,
the forward, ``Model.prefill`` and greedy ``Model.decode_step`` with
every cache leaf (whisper's cross cache at the F frames given,
pixtral's positions counting the image prefix), and ``Model.loss`` with
every leaf's gradient.

Inputs are made with numpy from a seed; parameters come from the JAX
package's ``init`` through ``params_from_numpy``. Tolerances: logits and
cache leaves 1e-4 (atol and rtol, the port's model tolerance), greedy
tokens equal, the loss 1e-5 and every gradient leaf 5e-4 (atol and
rtol, the training tests' bar), and the port's own decode against its
forward at the reference's 5e-4 / 1e-3 (tests/test_models_smoke.py).
"""

import dataclasses

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
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import parallel  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

WHISPER, PIXTRAL = "whisper-small", "pixtral-12b"
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
# whisper at F below and at encoder_max_frames (64 in the smoke config)
CASES = [(WHISPER, 8), (WHISPER, 64), (PIXTRAL, 0)]
IDS = ["whisper-F8", "whisper-F64", "pixtral"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    """arch -> (JAX model, JAX params, jitted prefill and decode_step,
    port model, port params), built once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jmodel = jax_build_model(jax_get_smoke(arch))
            jparams = jmodel.init(jax.random.PRNGKey(0))
            model = build_model(get_smoke(arch), "cpu")
            params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
            cache[arch] = (jmodel, jparams,
                           jax.jit(jmodel.prefill, static_argnums=2),
                           jax.jit(jmodel.decode_step), model, params)
        return cache[arch]
    return get


def _batch(cfg, seed, b, s, frames):
    """Tokens and the modality stub's features, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((b, frames, 128),
                                            dtype=np.float32)
    if cfg.num_image_tokens:
        out["image_feats"] = rng.standard_normal(
            (b, cfg.num_image_tokens, 1024), dtype=np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got: torch.Tensor, exp, tol=MODEL_TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def _close_tree(got, exp) -> None:
    """Leaf for leaf on the same paths, shapes and values."""
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    e = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, exp))[0]
    assert [p for p, _ in g] == [p for p, _ in e]
    for (path, t), (_, a) in zip(g, e):
        assert tuple(t.shape) == a.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(t.numpy(), a, **MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("seq,d", [(1, 8), (1500, 768), (64, 256)])
def test_sinusoidal_positions_match_the_reference(seq, d):
    # within the model tolerance: the frameworks' f32 powers differ by an
    # ulp, and at position 1499 one ulp of the f32 angle is 1.2e-4 rad
    _close(L.sinusoidal_positions(seq, d),
           jax_layers.sinusoidal_positions(seq, d), dict(atol=1e-4, rtol=0))


@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL, "qwen2-72b"])
@pytest.mark.parametrize("use_rope", [True, False])
def test_cross_attention_matches_the_reference(arch, use_rope):
    """``kv_x`` attends from x over other states with no RoPE and no
    window (qwen2: with its qkv biases); ``use_rope`` off drops RoPE
    from self-attention."""
    jcfg = dataclasses.replace(jax_get_smoke(arch), sliding_window=4)
    cfg = dataclasses.replace(get_smoke(arch), sliding_window=4)
    jp = jax_layers.init_cross_attention(jax.random.PRNGKey(2), jcfg)
    if "bq" in jp:
        jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, 20, cfg.d_model), dtype=np.float32)
    pos = np.arange(9)[None, :]
    exp, _ = jax_layers.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                  None, kv_x=jnp.asarray(enc),
                                  use_rope=use_rope, kind="full")
    got, _ = L.attention(params, cfg, torch.from_numpy(x),
                         torch.from_numpy(pos), kind="full",
                         kv_x=torch.from_numpy(enc), use_rope=use_rope)
    _close(got, exp)
    exp, _ = jax_layers.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                  None, use_rope=use_rope, kind="causal")
    got, _ = L.attention(params, cfg, torch.from_numpy(x),
                         torch.from_numpy(pos), kind="causal",
                         use_rope=use_rope)
    _close(got, exp)


# -------------------------------------------------------------------- model

@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_own_init_has_reference_shapes_and_dtypes(arch):
    """The encoder, the cross blocks and img_proj included."""
    jmodel = jax_build_model(jax_get_smoke(arch))
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    params = build_model(get_smoke(arch), "cpu").init(
        torch.Generator().manual_seed(0))
    got = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
        params)
    assert got == want
    assert ("encoder" in params) == (arch == WHISPER)
    assert ("img_proj" in params) == (arch == PIXTRAL)


@pytest.mark.parametrize("arch,frames", CASES, ids=IDS)
def test_forward_matches_jax(built, arch, frames):
    jmodel, jparams, _, _, model, params = built(arch)
    batch = _batch(model.cfg, 1, 2, 24, frames)
    exp, jaux = jax.jit(jmodel.forward)(jparams, _jax(batch))
    got, aux = model.forward(params, _torch(batch))
    assert got.shape == (2, 24, model.cfg.vocab_size)
    assert got.dtype == torch.float32
    _close(got, exp)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch,frames", CASES, ids=IDS)
def test_prefill_and_greedy_decode_match_jax(built, arch, frames):
    """Token by token, every leaf of the cache state: whisper's cross
    cache holds exactly the F frames of the prefill (so the trees match
    the reference's), pixtral's positions count its image prefix."""
    _, jparams, jprefill, jstep, model, params = built(arch)
    cfg = model.cfg
    prompt, steps = 9, 4
    npfx = cfg.num_image_tokens
    smax = npfx + prompt + steps
    batch = _batch(cfg, 2, 2, prompt, frames)
    exp, jstate = jprefill(jparams, _jax(batch), smax)
    got, state = model.prefill(params, _torch(batch), smax)
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, exp)
    _close_tree(state, jstate)
    if cfg.is_encoder_decoder:
        assert all(t.shape[2] == frames for t in jax.tree.leaves(state[1]))
    for i in range(steps):
        jtok = jnp.argmax(exp[:, -1:], axis=-1).astype(jnp.int32)
        tok = got[:, -1:].argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos = npfx + prompt + i
        exp, jstate = jstep(jparams, jtok, jnp.int32(pos), jstate)
        got, state = model.decode_step(params, tok, pos, state)
        _close(got, exp)
        _close_tree(state, jstate)


@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_decode_matches_the_ports_forward(built, arch):
    _, _, _, _, model, params = built(arch)
    cfg = model.cfg
    batch = _torch(_batch(cfg, 4, 2, 12, 8))
    full, _ = model.forward(params, batch)
    npfx = cfg.num_image_tokens
    pre = dict(batch, tokens=batch["tokens"][:, :9])
    got, state = model.prefill(params, pre, npfx + 12)
    torch.testing.assert_close(got[:, 0], full[:, 8], atol=5e-4, rtol=1e-3)
    for i in range(9, 12):
        got, state = model.decode_step(params, batch["tokens"][:, i:i + 1],
                                       npfx + i, state)
        torch.testing.assert_close(got[:, 0], full[:, i], atol=5e-4,
                                   rtol=1e-3)


def test_decode_continues_from_a_jax_prefill_cache(built):
    """A JAX cross cache of F frames, converted, is what decode reads."""
    _, jparams, jprefill, jstep, model, params = built(WHISPER)
    batch = _batch(model.cfg, 5, 2, 9, 8)
    _, jstate = jprefill(jparams, _jax(batch), 13)
    state = params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tok = np.array([[3], [5]], np.int32)
    exp, _ = jstep(jparams, jnp.asarray(tok), jnp.int32(9), jstate)
    got, _ = model.decode_step(params, torch.from_numpy(tok), 9, state)
    _close(got, exp)


def test_pixtral_cache_without_room_for_the_prefix_raises(built):
    _, _, _, _, model, params = built(PIXTRAL)
    batch = _torch(_batch(model.cfg, 6, 1, 9, 0))
    with pytest.raises(ValueError, match="modality prefix"):
        model.prefill(params, batch, 12)


@pytest.mark.parametrize("arch,frames", [(WHISPER, 8), (PIXTRAL, 0)],
                         ids=["whisper", "pixtral"])
def test_loss_and_every_gradient_match_the_reference(built, arch, frames):
    jmodel, jparams, _, _, model, _ = built(arch)
    batch = _batch(model.cfg, 7, 2, 16, frames)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, _jax(batch))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = model.loss(params, _torch(batch))
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5,
                               rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(grads)
    for (path, e), g in zip(jflat, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the modality's own leaves get gradient
    key = "encoder" if arch == WHISPER else "img_proj"
    assert float(jax.tree.leaves(jax.tree.map(
        lambda a: float(np.abs(np.asarray(a)).max()), jgrads[key]))[0]) > 0


@pytest.mark.parametrize("arch", [WHISPER, PIXTRAL])
def test_a_mesh_refuses_the_encoder_decoder_and_image_models(arch):
    with pytest.raises(NotImplementedError, match="A11b"):
        parallel._supported(get_smoke(arch))
