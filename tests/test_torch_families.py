"""The decoder-only families the port added last, on the CPU, against the
JAX reference: the dense phi3-mini, qwen2-72b (QKV bias) and granite-34b
(MQA, GELU), the MoE granite-moe and DeepSeek-V3 (MLA, shared expert,
MTP), and Jamba with its experts.

Inputs are made with numpy from a seed; model parameters come from the
JAX package's ``init`` through ``params_from_numpy``. Tolerances: the
port's model bar, f32 atol 1e-4 / rtol 1e-4 (tests/test_torch_models.py:
the frameworks sum in other orders), for logits, aux losses and every
cache leaf; greedy tokens are equal; the flash plain version against the
reference's oracle at the kernel bar, f32 2e-5 / 2e-5. Routing is
compared as ids: where the port's top-k experts differ from JAX's, the
token's k-th and (k+1)-th router probabilities must tie within 1e-6.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model_mod  # noqa: E402
from repro_torch.configs import _MODULES, get_arch, get_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.device import torch_dtype  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)
TIE = 1e-6
NEW = ["phi3-mini-3.8b", "qwen2-72b", "granite-34b", "granite-moe-1b-a400m",
       "deepseek-v3-671b"]
JAMBA = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    """arch -> (JAX model, JAX params, jitted JAX forward, prefill and
    decode_step, port model, port params), built once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jmodel = jax_build_model(jax_get_smoke(arch))
            jparams = jmodel.init(jax.random.PRNGKey(0))
            model = build_model(get_smoke(arch), "cpu")
            params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
            cache[arch] = (jmodel, jparams, jax.jit(jmodel.forward),
                           jax.jit(jmodel.prefill, static_argnums=2),
                           jax.jit(jmodel.decode_step), model, params)
        return cache[arch]
    return get


def _close(got: torch.Tensor, exp, tol=MODEL_TOL) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("getter", ["arch", "smoke"])
def test_configs_copy_the_reference(arch, getter):
    ours = (get_arch if getter == "arch" else get_smoke)(arch)
    theirs = (jax_get_arch if getter == "arch" else jax_get_smoke)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_count() == theirs.param_count()
    assert ours.pdtype == torch_dtype(theirs.param_dtype)


def test_every_registered_config_builds():
    """Every config the port registers builds, at published width and
    smoke size (building is free: no parameters are drawn), the image
    and encoder-decoder configs included."""
    assert set(_MODULES) >= set(NEW) | {JAMBA, "pixtral-12b",
                                         "whisper-small"}
    for arch in _MODULES:
        for cfg in (get_arch(arch), get_smoke(arch)):
            assert build_model(cfg, "cpu").cfg is cfg


@pytest.mark.parametrize("arch", NEW + [JAMBA])
def test_own_init_has_reference_shapes_and_dtypes(arch):
    jmodel = jax_build_model(jax_get_smoke(arch))
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    params = build_model(get_smoke(arch), "cpu").init(
        torch.Generator().manual_seed(0))
    got = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
        params)
    assert got == want


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("arch,b,s", [
    ("phi3-mini-3.8b", 2, 32),
    ("qwen2-72b", 2, 32),
    ("granite-34b", 2, 32),
    ("granite-moe-1b-a400m", 2, 32),    # t = 64: the drop-free floor
    ("granite-moe-1b-a400m", 2, 96),    # t = 192: capacity 120 an expert
    ("deepseek-v3-671b", 2, 32),
    ("deepseek-v3-671b", 2, 96),
    (JAMBA, 2, 128),                    # two scan chunks, MoE at t = 256
])
def test_forward_matches_jax(built, arch, b, s):
    _, jparams, jforward, _, _, model, params = built(arch)
    tokens = _tokens(0, model.cfg.vocab_size, b, s)
    exp, exp_aux = jforward(jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    _close(got, exp)
    _close(aux, exp_aux)
    if model.cfg.num_experts:
        assert float(aux) > 0.0


def test_mtp_loss_with_and_without_enable_mtp(built):
    """DeepSeek's aux is the routers' loss plus 0.1 x the MTP cross
    entropy, unless the batch says ``enable_mtp: False``."""
    jmodel, jparams, jforward, _, _, model, params = built(
        "deepseek-v3-671b")
    tokens = _tokens(1, model.cfg.vocab_size, 2, 32)
    # the flag is closed over: traced, the reference's ``is not False``
    # test would not see the Python bool
    jforward_no_mtp = jax.jit(lambda p, t: jmodel.forward(
        p, {"tokens": t, "enable_mtp": False}))
    auxes = []
    for flag, jfn in ((True, lambda p, t: jforward(p, {"tokens": t})),
                      (False, jforward_no_mtp)):
        _, exp = jfn(jparams, jnp.asarray(tokens))
        _, got = model.forward(params, {"tokens": torch.from_numpy(tokens),
                                        "enable_mtp": flag})
        _close(got, exp)
        auxes.append(float(got))
    h = torch.randn(2, 32, model.cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    mtp = model._mtp_loss(params, h, torch.from_numpy(tokens))
    jmtp = jax.jit(jmodel._mtp_loss)(jparams, jnp.asarray(h.numpy()),
                                     jnp.asarray(tokens))
    _close(mtp, jmtp)
    assert auxes[0] > auxes[1] > 0
    # fewer than 3 tokens: no target two ahead, no loss
    assert float(model._mtp_loss(params, h[:, :2],
                                 torch.from_numpy(tokens[:, :2]))) == 0.0


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 50), dtype=np.float32) * 4
    targets = rng.integers(0, 50, (2, 7)).astype(np.int32)
    _close(model_mod._cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(targets)),
           jax_model_mod._cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(targets)), KERNEL_TOL)


# ---------------------------------------------------------------------- MoE

def _moe_case(arch, t, seed, skew=0.0, **change):
    """A config, the JAX and port MoE parameters of one layer, and (t, d)
    tokens; ``skew`` adds a direction shared by every token, so that the
    router favours some experts and capacity drops assignments."""
    jcfg = dataclasses.replace(jax_get_smoke(arch), **change)
    cfg = dataclasses.replace(get_smoke(arch), **change)
    jp = jax_layers.init_moe(jax.random.PRNGKey(seed), jcfg)
    # the reference draws the (E, D, F) stacks at 1/sqrt(E), its fan-in
    # being the expert axis; rescaled to 1/sqrt(D) and 1/sqrt(F), the
    # layer's outputs are O(1), as in a block, and not ~500, where the
    # f32 bar would measure cancellation and not the algorithm
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    jp = dict(jp, wg=jp["wg"] * math.sqrt(e / d), wu=jp["wu"] * math.sqrt(
        e / d), wd=jp["wd"] * math.sqrt(e / f))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, cfg.d_model), dtype=np.float32)
    x = x + skew * rng.standard_normal(cfg.d_model, dtype=np.float32)
    # unit RMS a row, as the block's norm hands the MoE its input
    x = x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))
    return jcfg, cfg, jp, p, x


def _routing(p, x, k):
    """Check the port's top-k expert ids against JAX's: equal, or the
    token's k-th and (k+1)-th probabilities tie. Returns JAX's ids."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"].numpy()),
                           axis=-1)
    _, jids = jax.lax.top_k(probs, k)
    tprobs = torch.softmax(torch.from_numpy(x) @ p["router"], dim=-1)
    _, tids = torch.topk(tprobs, k, dim=-1)
    jids = np.asarray(jids)
    for row in np.nonzero((np.sort(jids, -1) != np.sort(tids.numpy(), -1))
                          .any(-1))[0]:
        top = np.sort(np.asarray(probs[row]))[::-1]
        assert top[k - 1] - top[k] <= TIE, (row, top[:k + 1])
    return jids


@pytest.mark.parametrize("arch,t,skew,change,drops", [
    ("granite-moe-1b-a400m", 64, 0.0, {}, False),        # drop-free floor
    ("granite-moe-1b-a400m", 192, 3.0, {}, True),        # drops
    ("granite-moe-1b-a400m", 192, 3.0, {"moe_groups": 2}, True),
    ("deepseek-v3-671b", 40, 0.0, {}, False),            # shared expert
    ("deepseek-v3-671b", 192, 3.0, {}, True),
    ("deepseek-v3-671b", 192, 3.0, {"moe_groups": 2}, True),
    ("deepseek-v3-671b", 30, 0.0, {"moe_groups": 4}, False),  # t % 4 != 0
    (JAMBA, 100, 3.0, {}, True),                         # top-2 of 4
], ids=["t64", "t192-drops", "groups2", "shared", "shared-drops",
        "shared-groups2", "groups-indivisible", "jamba"])
def test_moe_layer_matches_jax(arch, t, skew, change, drops):
    jcfg, cfg, jp, p, x = _moe_case(arch, t, seed=t, skew=skew, **change)
    ids = _routing(p, x, cfg.num_experts_per_tok)
    g = cfg.moe_groups if cfg.moe_groups > 1 and t % cfg.moe_groups == 0 \
        else 1
    per_group = [np.bincount(gi.ravel(), minlength=cfg.num_experts)
                 for gi in ids.reshape(g, -1, ids.shape[-1])]
    cap = L.moe_capacity(cfg, t // g)
    assert (max(c.max() for c in per_group) > cap) == drops
    exp, exp_aux = jax.jit(jax_layers.moe, static_argnums=1)(
        jp, jcfg, jnp.asarray(x)[None])
    got, aux = L.moe(p, cfg, torch.from_numpy(x)[None])
    _close(got, exp)
    _close(aux, exp_aux)
    assert ("shared" in p) == bool(cfg.num_shared_experts)


def test_moe_aux_alone_matches_jax():
    """The switch-style aux loss of one group on its own: E x sum over
    experts of (mean router probability x share of assignments) x
    the aux weight."""
    jcfg, cfg, jp, p, x = _moe_case("granite-moe-1b-a400m", 48, seed=9,
                                    skew=1.0)
    _, exp = jax_layers._moe_tokens(jp, jcfg, jnp.asarray(x))
    _, got = L._moe_tokens(p, cfg, torch.from_numpy(x))
    _close(got, exp, KERNEL_TOL)
    probs = torch.softmax(torch.from_numpy(x) @ p["router"], dim=-1)
    ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1).indices
    share = torch.bincount(ids.reshape(-1), minlength=cfg.num_experts) / \
        ids.numel()
    want = cfg.num_experts * float((probs.mean(0) * share).sum()) * \
        cfg.router_aux_weight
    assert float(got) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("t,expect", [(8, 8), (64, 64), (65, 41),
                                      (4096, 2560)])
def test_moe_capacity_from_shapes(t, expect):
    cfg = get_smoke("granite-moe-1b-a400m")        # 4 experts, top-2
    assert L.moe_capacity(cfg, t) == expect
    assert expect == max(math.ceil(t * 2 / 4 * 1.25), t if t <= 64 else 0)


# ---------------------------------------------------------------- MLA flash

@pytest.mark.parametrize("b,sq,sk,h,causal", [
    (2, 32, 32, 8, True),      # the scoring shape at smoke width
    (1, 40, 72, 4, True),      # ragged Sq < Sk
    (1, 24, 24, 4, False),
])
def test_flash_plain_at_mla_head_dims_matches_the_oracle(b, sq, sk, h,
                                                         causal):
    """D 192 (128 no-RoPE + 64 RoPE dims), Dv 128, one kv head a q head."""
    rng = np.random.default_rng(sq)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((b, sq, h, 192), (b, sk, h, 192),
                             (b, sk, h, 128)))
    exp = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal)
    assert got.shape == (b, sq, h, 128)
    _close(got, exp, KERNEL_TOL)


# ------------------------------------------------------- prefill and decode

def _close_cache(got_state, exp_state):
    got, exp = got_state, jax.tree.map(np.asarray, exp_state)
    assert got[1] is None and exp[1] is None
    n = 0
    for t, a in zip(jax.tree.leaves(got[0]), jax.tree.leaves(exp[0])):
        _close(t, a)
        n += 1
    assert n == len(jax.tree.leaves(exp[0])) > 0


@pytest.mark.parametrize("arch,prompt,steps,smax", [
    ("phi3-mini-3.8b", 9, 3, 16),
    ("qwen2-72b", 9, 3, 16),
    ("granite-34b", 9, 3, 16),
    ("granite-moe-1b-a400m", 40, 3, 48),   # a prefill of 80 tokens drops
    ("deepseek-v3-671b", 9, 3, 16),
    # MLA's absorbed decode past the cache: writes at pos >= smax clamp
    # into the last slot, as the reference's dynamic_update_slice does
    ("deepseek-v3-671b", 9, 10, 16),
    (JAMBA, 64, 3, 72),
])
def test_prefill_and_greedy_decode_match_jax(built, arch, prompt, steps,
                                             smax):
    _, jparams, _, jprefill, jstep, model, params = built(arch)
    tokens = _tokens(1, model.cfg.vocab_size, 2, prompt)
    exp, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, smax)
    got, state = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               smax)
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


def test_mla_decode_continues_from_a_jax_prefill_cache(built):
    """The absorbed decode reads the reference's latent cache as its own."""
    _, jparams, _, jprefill, jstep, model, params = built("deepseek-v3-671b")
    tokens = _tokens(2, model.cfg.vocab_size, 2, 9)
    _, jstate = jprefill(jparams, {"tokens": jnp.asarray(tokens)}, 16)
    state = params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert set(state[0][0][0]) == {"c_kv", "k_rope"}
    tok = np.array([[3], [5]], np.int32)
    exp, _ = jstep(jparams, jnp.asarray(tok), jnp.int32(9), jstate)
    got, _ = model.decode_step(params, torch.from_numpy(tok), 9, state)
    _close(got, exp)
