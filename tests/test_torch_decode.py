"""The port's decode path on the CPU against the JAX reference: the plain
decode-attention version against the Pallas kernel in interpret mode,
the KV cache's tree, and ``Model.prefill`` / ``Model.decode_step``.

Inputs are made with numpy from a seed and handed to both frameworks;
model parameters come from the JAX package's ``init`` through
``params_from_numpy``. Tolerances: the repo's kernel tolerances for the
kernel (f32 2e-5/2e-5, bf16 3e-2/3e-2, tests/test_kernels.py) and the
port's model tolerance for logits and caches (f32 1e-4/1e-4, as in
tests/test_torch_models.py: the frameworks sum in other orders). The
card-only checks of the CUDA kernel are in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro_torch.configs import get_arch, get_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import decode_attention as da_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, kvcache  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["llama3.2-1b", "llama3.2-1b-sw", "xlstm-125m"]

# jitted once, so that calls at one shape share a compile (the file's
# CPU time is mostly JAX compiling)
jax_decode_jit = jax.jit(jax_decode, static_argnames=("window", "interpret"))
jax_decode_ref = jax.jit(jax_ref.decode_attention_ref,
                         static_argnames=("window",))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, b, smax, h, kv, d, dtype):
    """The same q, k, v as JAX arrays and torch tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in ((b, 1, h, d), (b, smax, kv, d), (b, smax, kv, d))]
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays])


def _close(got: torch.Tensor, exp, tol) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


# ------------------------------------------------------------------ kernel

@pytest.mark.parametrize("b,smax,h,kv,d", [
    (1, 512, 4, 4, 64),
    (2, 1024, 8, 2, 64),
    (4, 512, 4, 1, 128),
    (2, 512, 48, 1, 128),   # G = 48 (granite-34b)
    (2, 512, 12, 2, 64),    # G = 6, not a power of two
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_interpret(b, smax, h, kv, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(5, b, smax, h, kv, d, dtype)
    vl = smax // 2 + 17
    exp = jax_decode_jit(jq, jk, jv, vl, interpret=True)
    got = ops.attention(tq, tk, tv, None, TORCH_DTYPE[dtype], kind="decode",
                        valid_len=vl)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, 1, h, d)
    _close(got, exp, TOL[dtype])
    _close(got, jax_decode_ref(jq, jk, jv, vl), TOL[dtype])


@pytest.mark.parametrize("vl,window", [(1, 0), (511, 0), (512, 0),
                                       (400, 128)])
def test_decode_valid_len_edges_and_window(vl, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(6, 2, 512, 4, 2, 64, "float32")
    exp = jax_decode_jit(jq, jk, jv, vl, window=window, interpret=True)
    got = da_mod.decode_attention(tq, tk, tv, vl, window=window)
    _close(got, exp, TOL["float32"])
    _close(ref.decode_attention_ref(tq, tk, tv, vl, window=window),
           jax_decode_ref(jq, jk, jv, vl, window=window),
           TOL["float32"])


def test_decode_plain_takes_per_sequence_valid_len():
    (jq, jk, jv), (tq, tk, tv) = _qkv(7, 3, 96, 4, 2, 16, "float32")
    vl = np.array([1, 40, 96], np.int32)
    exp = jax_decode_ref(jq, jk, jv, jnp.asarray(vl), window=32)
    got = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(vl),
                                   window=32)
    _close(got, exp, TOL["float32"])


def test_decode_without_valid_len_raises():
    q = torch.zeros(1, 1, 2, 8)
    with pytest.raises(ValueError, match="valid_len"):
        ops.attention(q, q, q, None, torch.float32, kind="decode")


@pytest.mark.parametrize("b,kvh,n_keys,sms", [
    (8, 8, 1024, 132), (8, 8, 513, 132), (8, 8, 1, 132), (1, 1, 0, 132),
    (1, 4, 600, 132), (64, 8, 4096, 132), (2, 2, 64, 8),
    (2, 1, 1024, 132),      # granite-34b's decode: 48 q heads over 1
    (1, 8, 8192, 132)])     # one sequence, 8192 keys: the cluster cap
def test_split_plan_covers_every_key_once(b, kvh, n_keys, sms):
    for group in (1, 4, 6, 8, 16, 17, 48, 64):
        splits, chunk, groups = da_mod.split_plan(b, kvh, n_keys, sms,
                                                  group)
        assert 1 <= splits <= da_mod.MAX_SPLITS and chunk % da_mod.TILE == 0
        assert splits * chunk >= n_keys                      # every key
        assert n_keys == 0 or (splits - 1) * chunk < n_keys  # no empty chunk
        # the head groups cover the group exactly: none over 16, none empty
        per = -(-group // groups)
        assert per <= da_mod.HEADS_PER_CTA and (groups - 1) * per < group


def test_split_plan_fills_the_card_at_the_served_shape():
    # B = 8 sequences x 8 kv heads, 1024 valid keys, 132 SMs: clusters of
    # 5 CTAs, 224 keys each, 320 CTAs (about 2.5 an SM)
    assert da_mod.split_plan(8, 8, 1024, 132, 4) == (5, 224, 1)
    # one sequence over 8192 keys: the cluster cap, 32 tiles a CTA
    assert da_mod.split_plan(1, 8, 8192, 132, 4) == (8, 1024, 1)
    # granite-34b: 48 q heads over 1 kv head take 12 CTAs of 4 heads
    assert da_mod.split_plan(2, 1, 1024, 132, 48) == (8, 128, 12)


# ------------------------------------------------------------------- cache

def _shapes(tree):
    return jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
        tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("getter", ["smoke", "arch"])
def test_init_cache_matches_reference(arch, getter):
    ours = (get_smoke if getter == "smoke" else get_arch)(arch)
    theirs = (jax_get_smoke if getter == "smoke" else jax_get_arch)(arch)
    for batch, smax in ((2, 40), (1, 100)):
        want = jax.eval_shape(lambda: jax_kvcache.init_cache(theirs, batch,
                                                             smax))
        got = kvcache.init_cache(ours, batch, smax, device="meta")
        assert _shapes(got) == _shapes(want)
        assert kvcache.cache_bytes(ours, batch, smax) == \
            jax_kvcache.cache_bytes(theirs, batch, smax)


def test_init_cache_values_match_reference():
    """Zeros, and the mLSTM / sLSTM stabilizers' initial -1e30 / -1e9."""
    cfg = get_smoke("xlstm-125m")
    want = jax_kvcache.init_cache(jax_get_smoke("xlstm-125m"), 2, 8)
    got = kvcache.init_cache(cfg, 2, 8, device="cpu")
    jax.tree.map(lambda t, a: np.testing.assert_array_equal(
        t.numpy(), np.asarray(a)), got, want)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def built():
    """arch -> (JAX model, JAX params, jitted JAX prefill and
    decode_step, port model, port params), built once per arch so that
    no step retraces."""
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


def _close_cache(got_state, exp_state):
    got, exp = got_state, jax.tree.map(np.asarray, exp_state)
    assert got[1] is None and exp[1] is None
    jax.tree.map(lambda t, a: np.testing.assert_allclose(
        t.numpy(), a, **MODEL_TOL), got[0], exp[0])


@pytest.mark.parametrize("arch,prompt,steps,smax", [
    ("llama3.2-1b", 9, 3, 16),
    # prompt 96 > window 64: the ring tail at prefill, then 40 steps that
    # wrap the 64-slot ring
    ("llama3.2-1b-sw", 96, 40, 160),
])
def test_prefill_and_greedy_decode_match_jax(built, arch, prompt, steps,
                                             smax):
    _, jparams, jprefill, jstep, model, params = built(arch)
    tokens = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, prompt)).astype(np.int32)
    exp, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, smax)
    got, state = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               smax)
    assert got.shape == (2, 1, model.cfg.vocab_size)
    assert got.dtype == torch.float32
    _close(got, exp, MODEL_TOL)
    _close_cache(state, jstate)
    for i in range(steps):
        jtok = jnp.argmax(exp[:, -1:], axis=-1).astype(jnp.int32)
        tok = got[:, -1:].argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        exp, jstate = jstep(jparams, jtok, jnp.int32(prompt + i), jstate)
        got, state = model.decode_step(params, tok, prompt + i, state)
        _close(got, exp, MODEL_TOL)
        _close_cache(state, jstate)


def test_decode_step_continues_from_a_jax_prefill_cache(built):
    _, jparams, jprefill, jstep, model, params = built("llama3.2-1b")
    tokens = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (2, 9)).astype(np.int32)
    _, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, 16)
    state = params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert state[1] is None
    tok = np.array([[3], [5]], np.int32)
    exp, _ = jstep(jparams, jnp.asarray(tok), jnp.int32(9), jstate)
    got, _ = model.decode_step(params, torch.from_numpy(tok), 9, state)
    _close(got, exp, MODEL_TOL)


def test_full_cache_write_clamps_like_the_reference(built):
    """At pos >= smax a full-attention cache's write lands in the last
    slot (the reference's dynamic_update_slice clamps the start). The
    prompt and cache sizes are the first test's, so no call recompiles."""
    _, jparams, jprefill, jstep, model, params = built("llama3.2-1b")
    smax = 16
    tokens = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (2, 9)).astype(np.int32)
    _, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, smax)
    _, state = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                             smax)
    for pos in range(9, smax + 2):
        tok = np.array([[pos + 11], [pos + 2]], np.int32)
        exp, jstate = jstep(jparams, jnp.asarray(tok), jnp.int32(pos),
                            jstate)
        got, state = model.decode_step(params, torch.from_numpy(tok), pos,
                                       state)
        _close(got, exp, MODEL_TOL)
        _close_cache(state, jstate)


def test_full_cache_shorter_than_the_prompt_raises():
    model = build_model(get_smoke("llama3.2-1b"), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="full-attention cache too small"):
        model.prefill(params, {"tokens": torch.zeros((1, 9),
                                                     dtype=torch.long)}, 8)


def test_decode_matches_the_ports_forward(built):
    """Prefill + decode reproduces the port's own forward logits (the
    reference's decode-vs-forward tolerance, tests/test_models_smoke.py)."""
    _, _, _, _, model, params = built("llama3.2-1b")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (2, 12)))
    full, _ = model.forward(params, {"tokens": tokens})
    got, state = model.prefill(params, {"tokens": tokens[:, :9]}, 12)
    torch.testing.assert_close(got[:, 0], full[:, 8], atol=5e-4, rtol=1e-3)
    for i in range(9, 12):
        got, state = model.decode_step(params, tokens[:, i:i + 1], i, state)
        torch.testing.assert_close(got[:, 0], full[:, i], atol=5e-4,
                                   rtol=1e-3)
