"""The port's Mamba path on the CPU against the JAX reference: the plain
selective scan and ``ops.mamba_chunk`` against the reference's oracle
(``ref.mamba_scan_ref``) and its XLA associative scan, the Mamba block,
and the expert-free one-period Jamba (forward, prefill, greedy decode).

The reference's Pallas scan cannot run here in interpret mode (the
installed jax has no ``pl.store``), so its oracle and XLA branch are
what the port is held to. Inputs are made with numpy from a seed and
handed to both frameworks, and so are parameters: the port's ``init``
(whose tree is checked against the reference's) handed to JAX, since the
reference's ``init`` takes seconds on the CPU. Tolerances: the repo's
kernel tolerances for the scan (f32 2e-5/2e-5, bf16 3e-2/3e-2, the state
5e-5; tests/test_kernels.py) and the port's model tolerance for blocks,
logits and caches (f32 1e-4/1e-4, as in tests/test_torch_models.py).
The card-only checks of the CUDA kernel are in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_arch, get_smoke, without_experts  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import mamba_scan as ms_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, kvcache  # noqa: E402
from repro_torch.models import layers  # noqa: E402

JAMBA = "jamba-1.5-large-398b"
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
STATE_TOL = dict(atol=5e-5, rtol=5e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# jitted once per shape; the JAX ops' XLA branch is what it takes on the
# CPU (no TPU, no forced interpret mode)
jax_scan_ref = jax.jit(jax_ref.mamba_scan_ref)
jax_scan_xla = jax.jit(jax_ops.mamba_chunk)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _scan_inputs(seed, b, s, d, n):
    """dt, x, b, c, a, h0 as numpy f32, distributed as the reference's
    kernel sweep draws them."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)) * 0.3))
    return [a.astype(np.float32) for a in (
        dt, rng.standard_normal((b, s, d)),
        rng.standard_normal((b, s, n)) * 0.5,
        rng.standard_normal((b, s, n)) * 0.5,
        -np.exp(rng.standard_normal((d, n)) * 0.3),
        rng.standard_normal((b, d, n)) * 0.1)]


def _both(arrays, dtype):
    """dt, x, b, c in ``dtype``, a and h0 in f32, as JAX arrays and torch
    tensors holding the same values."""
    j = [jnp.asarray(a).astype(dtype) for a in arrays[:4]] + \
        [jnp.asarray(a) for a in arrays[4:]]
    t = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays[:4]] + \
        [torch.from_numpy(a) for a in arrays[4:]]
    return j, t


def _close(got: torch.Tensor, exp, tol) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


# -------------------------------------------------------------------- scan

@pytest.mark.parametrize("b,s,d,n", [
    (2, 512, 256, 16),
    (1, 256, 128, 32),
    (3, 384, 192, 16),       # non-pow2 batch / channels
    (2, 128, 256, 8),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_the_reference_oracle_and_xla(b, s, d, n, dtype):
    (jdt, jx, jb, jc, ja, jh), args = _both(_scan_inputs(11, b, s, d, n),
                                            dtype)
    ye, he = jax_scan_ref(jdt, jx, jb, jc, ja, jh)
    y, h = ref.mamba_scan_ref(*args)
    assert y.dtype == TORCH_DTYPE[dtype] and y.shape == (b, s, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    _close(y, ye, TOL[dtype])
    _close(h, he, STATE_TOL)
    # the model's entry point: f32 y, the XLA associative scan as oracle
    yx, hx = jax_scan_xla(jdt, jx, jb, jc, ja, jh)
    y, h = ops.mamba_chunk(*args)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, yx, TOL[dtype])
    _close(h, hx, STATE_TOL)


def test_scan_state_carries_across_calls():
    """Two half-length calls chained through h == one full call, and both
    == the reference."""
    # a shape of the sweep above, so that the JAX oracle's compile is
    # shared
    arrays = _scan_inputs(12, 1, 256, 128, 32)
    arrays[5] = np.zeros_like(arrays[5])
    (jdt, jx, jb, jc, ja, jh), (dt, x, b, c, a, h0) = _both(arrays,
                                                           "float32")
    y_full, h_full = ops.mamba_chunk(dt, x, b, c, a, h0)
    y1, h1 = ops.mamba_chunk(dt[:, :128], x[:, :128], b[:, :128],
                             c[:, :128], a, h0)
    y2, h2 = ops.mamba_chunk(dt[:, 128:], x[:, 128:], b[:, 128:],
                             c[:, 128:], a, h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full,
                               **TOL["float32"])
    torch.testing.assert_close(h2, h_full, **TOL["float32"])
    ye, he = jax_scan_ref(jdt, jx, jb, jc, ja, jh)
    _close(torch.cat([y1, y2], dim=1), ye, TOL["float32"])
    _close(h2, he, STATE_TOL)


def test_scan_takes_strided_halves_of_one_projection():
    """ops copies the (B,L,2N) halves the block hands it; the result is the
    same as for contiguous inputs."""
    dt, x, b, c, a, h0 = (torch.from_numpy(v) for v in
                          _scan_inputs(13, 2, 16, 32, 8))
    bc = torch.cat([b, c], dim=-1)
    b_v, c_v = bc.chunk(2, dim=-1)
    assert not b_v.is_contiguous()
    got = ops.mamba_chunk(dt, x, b_v, c_v, a, h0)
    exp = ref.mamba_scan_ref(dt, x, b, c, a, h0)
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=0, atol=0)


# ex2.approx.ftz.f32 is within 2 ulp (the bound CUDA states for exp2f,
# which is the same MUFU.EX2 instruction): a relative 2^-22. The emulation
# perturbs every a_bar by up to twice that.
EX2_REL_ERR = 2.0 ** -21


def _kernel_arithmetic(dt, x, b, c, a, h0, seed):
    """The CUDA scan's arithmetic (``csrc/mamba_scan.cu``), in f32 torch:
    A' = A log2(e) rounded to f32 once, a_bar = exp2(dt A') with each value
    scaled by 1 + u, u uniform in +-EX2_REL_ERR, h = a_bar h + (dt x) B,
    and y as N/4 chains of 4 products (n = 4q .. 4q + 3) added pairwise,
    the order of both the scan kernel and the step kernel's shuffles."""
    gen = torch.Generator().manual_seed(seed)
    dtf, xf, bf, cf = (t.float() for t in (dt, x, b, c))
    a2 = a.float() * torch.tensor(1.4426950408889634, dtype=torch.float32)
    h = h0.float().clone()
    bsz, length, d = dtf.shape
    n = a.shape[-1]
    ys = []
    for t in range(length):
        a_bar = torch.exp2(dtf[:, t, :, None] * a2)
        u = torch.rand(a_bar.shape, generator=gen) * 2 - 1
        a_bar = a_bar * (1 + u * EX2_REL_ERR)
        bx = dtf[:, t] * xf[:, t]
        h = a_bar * h + bx[..., None] * bf[:, t, None, :]
        prods = (h * cf[:, t, None, :]).reshape(bsz, d, n // 4, 4)
        acc = prods[..., 0]
        for j in range(1, 4):
            acc = acc + prods[..., j]
        while acc.shape[-1] > 1:
            acc = acc[..., 0::2] + acc[..., 1::2]
        ys.append(acc[..., 0])
    return torch.stack(ys, dim=1).to(x.dtype), h


@pytest.mark.parametrize("b,s,d,n,inputs", [
    (2, 512, 256, 16, "sweep"),
    (1, 256, 128, 32, "sweep"),
    (3, 384, 192, 16, "sweep"),
    (2, 128, 256, 8, "sweep"),
    (8, 256, 256, 16, "sweep"),     # the hybrid's prefill chunk, D cut
    (8, 256, 256, 16, "hybrid"),    # ... with the Mamba block's A and dt
    (8, 1, 256, 16, "hybrid"),      # a decode step: the step kernel
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_kernel_arithmetic_meets_the_bar(b, s, d, n, inputs, dtype):
    """Why the kernel may take ex2.approx of a pre-scaled A and sum y in
    chains: with every a_bar off by twice its documented error, the result
    stays within the repo's bars of the plain version."""
    arrays = _scan_inputs(21, b, s, d, n)
    if inputs == "hybrid":
        # layers.init_mamba: A = -exp(log(1..N)), dt = softplus(0.1 x - 2)
        rng = np.random.default_rng(22)
        arrays[0] = np.log1p(np.exp(0.1 * rng.standard_normal((b, s, d))
                                    - 2.0)).astype(np.float32)
        arrays[4] = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                                     (d, n)).copy()
    args = [torch.from_numpy(v).to(TORCH_DTYPE[dtype]) for v in arrays[:4]] \
        + [torch.from_numpy(v) for v in arrays[4:]]
    y, h = _kernel_arithmetic(*args, seed=23)
    ye, he = ref.mamba_scan_ref(*args)
    assert y.dtype == TORCH_DTYPE[dtype]
    torch.testing.assert_close(y.float(), ye.float(), **TOL[dtype])
    torch.testing.assert_close(h, he, **STATE_TOL)


# ------------------------------------------------------------------- block

@pytest.fixture(scope="module")
def block_params():
    """The reference's config and the port's ``init_mamba`` parameters in
    both frameworks."""
    params = layers.init_mamba(torch.Generator().manual_seed(3),
                               get_smoke(JAMBA), torch.device("cpu"))
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    return jax_get_smoke(JAMBA), jp, params


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    d_in = cfg.d_model * cfg.mamba_expand
    return {"h": (rng.standard_normal((b, d_in, cfg.mamba_d_state))
                  * 0.3).astype(np.float32),
            "conv": rng.standard_normal((b, cfg.mamba_d_conv - 1, d_in)
                                        ).astype(np.float32)}


@pytest.mark.parametrize("s,carried", [
    (128, False),           # two chunks of ssm_chunk 64
    (96, False),            # ragged: one chunk of 96
    (1, True),              # a decode step from a carried state
], ids=["two-chunks", "ragged", "continuation"])
def test_mamba_block_matches_jax(block_params, s, carried):
    jcfg, jp, params = block_params
    cfg = get_smoke(JAMBA)
    x = (np.random.default_rng(4).standard_normal((2, s, cfg.d_model))
         ).astype(np.float32)
    jstate = tstate = None
    if carried:
        st = _state(jcfg, 2, 5)
        jstate = {k: jnp.asarray(v) for k, v in st.items()}
        tstate = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    exp, jnew = jax_layers.mamba_block(jp, jcfg, jnp.asarray(x), jstate)
    got = layers.mamba_block(params, cfg, torch.from_numpy(x), tstate)
    assert got.shape == (2, s, cfg.d_model) and got.dtype == torch.float32
    _close(got, exp, MODEL_TOL)
    if carried:         # the state is written in place
        _close(tstate["h"], jnew["h"], MODEL_TOL)
        _close(tstate["conv"], jnew["conv"], MODEL_TOL)


def test_mamba_block_with_state_equals_chunks_of_the_sequence(block_params):
    """A sequence run in one call equals the same sequence run in two
    calls that carry the state (h and the conv tail) between them."""
    _, _, params = block_params
    cfg = get_smoke(JAMBA)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 80, cfg.d_model)).astype(np.float32))
    d_in = cfg.d_model * cfg.mamba_expand
    state = {"h": torch.zeros(2, d_in, cfg.mamba_d_state),
             "conv": torch.zeros(2, cfg.mamba_d_conv - 1, d_in)}
    full = layers.mamba_block(params, cfg, x)
    first = layers.mamba_block(params, cfg, x[:, :64], state)
    second = layers.mamba_block(params, cfg, x[:, 64:], state)
    torch.testing.assert_close(torch.cat([first, second], dim=1), full,
                               **MODEL_TOL)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def hybrid():
    """The expert-free one-period Jamba smoke model in both frameworks,
    built once, with the JAX entry points jitted once. The parameters
    are the port's ``init`` handed to JAX as numpy arrays (the JAX
    ``init`` of eight layers takes seconds to run on the CPU; its tree
    is checked against the port's below)."""
    jmodel = jax_build_model(without_experts(jax_get_smoke(JAMBA)))
    model = build_model(without_experts(get_smoke(JAMBA)), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    return (jmodel, jparams, jax.jit(jmodel.forward),
            jax.jit(jmodel.prefill, static_argnums=2),
            jax.jit(jmodel.decode_step), model, params)


def test_expert_free_variant_is_one_dense_period():
    cfg = without_experts(get_arch(JAMBA))
    jcfg = without_experts(jax_get_arch(JAMBA))
    kinds = [(b.kind, b.ffn) for b in cfg.segments[0].blocks]
    assert kinds == [(b.kind, b.ffn) for b in jcfg.segments[0].blocks]
    assert kinds == [("attn" if i == 4 else "mamba", "dense")
                     for i in range(8)]
    assert cfg.num_layers == 8 and cfg.segments[0].repeat == 1
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.mamba_d_state, cfg.mamba_d_conv, cfg.mamba_expand,
            cfg.ssm_chunk) == (8192, 64, 8, 128, 24576, 65536, 16, 4, 2, 256)
    assert jcfg.param_count() == 8_881_356_800


def test_hybrid_forward_matches_jax(hybrid):
    _, jparams, jforward, _, _, model, params = hybrid
    tokens = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 128)).astype(np.int32)
    exp, _ = jforward(jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 128, model.cfg.vocab_size) and float(aux) == 0
    _close(got, exp, MODEL_TOL)


def _close_cache(got_state, exp_state):
    got, exp = got_state, jax.tree.map(np.asarray, exp_state)
    assert got[1] is None and exp[1] is None
    jax.tree.map(lambda t, a: np.testing.assert_allclose(
        t.float().numpy(), a, **MODEL_TOL), got[0], exp[0])


def test_hybrid_prefill_and_greedy_decode_match_jax(hybrid):
    """Prefill of 128 tokens (two scan chunks) into 160 slots, then 8
    greedy steps: logits and every cache leaf at each step, and the
    greedy tokens equal."""
    _, jparams, _, jprefill, jstep, model, params = hybrid
    prompt, smax, steps = 128, 160, 8
    tokens = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, prompt)).astype(np.int32)
    exp, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, smax)
    got, state = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               smax)
    assert got.shape == (2, 1, model.cfg.vocab_size)
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


def test_hybrid_decode_continues_from_a_jax_prefill_cache(hybrid):
    """The reference's cache state converts and the port decodes from it
    (same shapes as the test above, so nothing recompiles)."""
    _, jparams, _, jprefill, jstep, model, params = hybrid
    tokens = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (2, 128)).astype(np.int32)
    _, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, 160)
    state = params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tok = np.array([[3], [5]], np.int32)
    exp, jstate = jstep(jparams, jnp.asarray(tok), jnp.int32(128), jstate)
    got, state = model.decode_step(params, torch.from_numpy(tok), 128,
                                   state)
    _close(got, exp, MODEL_TOL)
    _close_cache(state, jstate)


def _shapes(tree):
    return jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
        tree)


def test_hybrid_init_has_the_reference_tree(hybrid):
    jmodel, _, _, _, _, model, _ = hybrid
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    got = model.init(torch.Generator().manual_seed(0))
    assert _shapes(got) == _shapes(want)
    core = got["segments"][0][0]["core"]
    np.testing.assert_allclose(
        core["a_log"][0, 0].numpy(), np.log(np.arange(1, 17)), rtol=1e-6)
    assert float(core["w_dt"][0, 0]) == pytest.approx(0.1)
    assert float(core["b_dt"][0, 0]) == -2.0


@pytest.mark.parametrize("getter", ["smoke", "arch"])
def test_hybrid_cache_matches_reference(getter):
    ours = (get_smoke if getter == "smoke" else get_arch)(JAMBA)
    theirs = (jax_get_smoke if getter == "smoke" else jax_get_arch)(JAMBA)
    for batch, smax in ((2, 40), (8, 1024)):
        want = jax.eval_shape(lambda: jax_kvcache.init_cache(theirs, batch,
                                                             smax))
        got = kvcache.init_cache(ours, batch, smax, device="meta")
        assert _shapes(got) == _shapes(want)
        assert kvcache.cache_bytes(ours, batch, smax) == \
            jax_kvcache.cache_bytes(theirs, batch, smax)


def test_cpu_scan_counts_no_launch():
    args = [torch.from_numpy(v) for v in _scan_inputs(14, 1, 4, 8, 8)]
    before = ms_mod.counter.count
    ops.mamba_chunk(*args)
    assert ms_mod.counter.count == before
