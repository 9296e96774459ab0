"""The port's training half on the CPU, against the JAX reference: flash
attention's forward with its logsumexp and its backward, the RMSNorm
gradient, ``Model.loss`` and its gradient for every parameter leaf,
AdamW's update, ``make_train_step`` with and without microbatches,
``Trainer.fit``, the synthetic data and the checkpoint format.

Inputs are made with numpy from a seed and handed to both frameworks;
model parameters come from the JAX package's ``init`` through
``params_from_numpy``. Tolerances:
- flash forward and lse 3e-5 and gradients 5e-4 (atol and rtol), the
  reference's own bars for its custom VJP (tests/test_kernels.py:183-213);
- RMSNorm gradients f32 1e-5, bf16 3e-2 (the kernel tolerance in bf16);
- the loss and every gradient leaf 1e-5 relative to the leaf's largest
  entry: the frameworks sum in other orders, and an entry near zero
  carries absolute, not relative, error; Jamba's leaves 3e-5: the
  reference's own two scans differ by more than 5e-6 on that config;
- AdamW 1e-6: the same f32 operations in the same order, one rounding
  of the bf16 moments apart at most.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import xla_flash  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import data as jax_data  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import decode_attention as da_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as ms_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import AdamW, AdamWState, Trainer, make_train_step  # noqa: E402
from repro_torch.train import checkpoint, data  # noqa: E402
from repro_torch.train.tree import flatten_with_path, leaves  # noqa: E402

FWD_TOL = dict(atol=3e-5, rtol=3e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
LEAF_REL = 1e-5
OPT_TOL = dict(atol=1e-6, rtol=1e-6)
LOSS_ARCHES = ["llama3.2-1b", "llama3.2-1b-sw", "deepseek-v3-671b",
               "jamba-1.5-large-398b"]
# a length where each config's structure bites: the -sw window of 64 at
# 80, Jamba's scan in two chunks of its ssm_chunk 64 at 128
LOSS_SEQ = {"llama3.2-1b-sw": 80, "jamba-1.5-large-398b": 128}
# Jamba's leaves: the reference's own two scans, its sequential oracle and
# the associative scan of its XLA path, give gradients more than 5e-6 of
# the largest entry apart on this config (the dt path's sums over N
# cancel; tests/test_torch_mamba_train.py::
# test_jamba_gradients_sit_between_the_reference_scans), so the port's
# sequential scan is held to 3e-5
LEAF_REL_ARCH = {"jamba-1.5-large-398b": 3e-5}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a: np.ndarray, requires_grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# -------------------------------------------------------------------- flash

FLASH_CASES = [
    # (b, sq, sk, h, kv, d, dv, causal, window): the reference's five
    # (tests/test_kernels.py:183-189), which cover G 1, 2 and 4, window 64
    # and the ragged (100, 200); then D 192 / Dv 128 and D != Dv windowed
    pytest.param(2, 256, 256, 4, 4, 64, 64, True, 0, id="causal-G1"),
    pytest.param(2, 128, 384, 4, 2, 64, 64, True, 0, id="sq<sk-G2"),
    pytest.param(2, 256, 256, 4, 1, 64, 64, False, 0, id="full-G4"),
    pytest.param(2, 256, 256, 8, 2, 64, 64, True, 64, id="window64-G4"),
    pytest.param(2, 100, 200, 4, 2, 64, 64, True, 0, id="ragged-100x200"),
    pytest.param(1, 64, 96, 4, 4, 192, 128, True, 0, id="mla-192/128"),
    pytest.param(1, 70, 90, 6, 3, 32, 16, True, 16, id="d!=dv-window"),
]


def _flash_inputs(seed, b, sq, sk, h, kv, d, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kv, d), dtype=np.float32),
            rng.standard_normal((b, sk, kv, dv), dtype=np.float32),
            rng.standard_normal((b, sq, h, dv), dtype=np.float32))


def _jax_flash_fwd(q, k, v, causal, window):
    """xla_flash's forward with its lse, padded as flash_attention_xla
    pads, cut back to Sq rows."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    bq = xla_flash._largest_block(sq) or 512
    bk = xla_flash._largest_block(sk) or 512
    sq_pad, sk_pad = -(-sq // bq) * bq, -(-sk // bk) * bk
    pad = lambda a, n: jnp.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0),  # noqa: E731
                                   (0, 0)))
    out, lse = xla_flash._flash_fwd_impl(
        pad(q, sq_pad), pad(k, sk_pad), pad(v, sk_pad), causal, window,
        1.0 / math.sqrt(d), bq, bk, sk, sk - sq)
    return out[:, :sq], lse[:, :sq]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", FLASH_CASES)
def test_flash_forward_and_lse_match_the_reference(b, sq, sk, h, kv, d, dv,
                                                   causal, window):
    q, k, v, _ = _flash_inputs(0, b, sq, sk, h, kv, d, dv)
    exp_out, exp_lse = _jax_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, window)
    out, lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                       window=window, return_lse=True)
    assert lse.shape == (b, sq, h) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(exp_out), **FWD_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(exp_lse), **FWD_TOL)
    # the plain forward without lse is the same call it always was
    assert torch.equal(ref.flash_attention_ref(_t(q), _t(k), _t(v), causal,
                                               window), out)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", FLASH_CASES)
def test_flash_backward_matches_both_reference_gradients(b, sq, sk, h, kv, d,
                                                         dv, causal, window):
    """The port's differentiable flash (the Function: plain forward with
    lse, blockwise backward) against jax.grad of the reference's custom
    VJP and of its oracle."""
    q, k, v, do = _flash_inputs(1, b, sq, sk, h, kv, d, dv)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))

    def f_flash(q, k, v):
        return (xla_flash.flash_attention_xla(q, k, v, causal=causal,
                                              window=window) * jdo).sum()

    def f_ref(q, k, v):
        return (jax_ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window) * jdo).sum()

    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fa_mod.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__.startswith("FlashAttention")
    got = torch.autograd.grad((out * _t(do)).sum(), (tq, tk, tv))
    for f in (f_flash, f_ref):
        exp = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
        for g, e in zip(got, exp):
            np.testing.assert_allclose(_np(g), np.asarray(e), **GRAD_TOL)


@pytest.mark.parametrize("block", [16, 64, 256])
def test_flash_backward_blocks_do_not_change_the_gradient(block):
    q, k, v, do = (_t(a) for a in _flash_inputs(2, 2, 100, 200, 4, 2, 32,
                                                  32))
    out, lse = ref.flash_attention_ref(q, k, v, window=48, return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, window=48,
                                       block=256)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, window=48,
                                      block=block)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_rows_that_see_no_key_get_zero_gradients():
    """Sq > Sk causal: the first Sq - Sk rows see no key. Their lse is
    +inf, their dQ is zero, and dK / dV are those of the other rows
    alone (the port's forward gives such a row 0, by design)."""
    b, sq, sk, h, kv, d = 1, 48, 16, 4, 1, 32
    q, k, v, do = (_t(a) for a in _flash_inputs(3, b, sq, sk, h, kv, d, d))
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    blind = sq - sk
    assert torch.isinf(lse[:, :blind]).all() and (lse[:, :blind] > 0).all()
    assert torch.isfinite(lse[:, blind:]).all()
    assert out[:, :blind].abs().max() == 0
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    assert dq[:, :blind].abs().max() == 0
    do_seen = do.clone()
    do_seen[:, :blind] = 0
    _, dk2, dv2 = ref.flash_attention_bwd_ref(q, k, v, out, lse, do_seen)
    torch.testing.assert_close(dk, dk2, atol=0, rtol=0)
    torch.testing.assert_close(dv, dv2, atol=0, rtol=0)
    # and the Function's gradient is the autodiff of the plain forward
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    got = torch.autograd.grad(
        (fa_mod.flash_attention(tq, tk, tv) * do).sum(), (tq, tk, tv))
    pq, pk, pv = (t.clone().requires_grad_(True) for t in (q, k, v))
    exp = torch.autograd.grad(
        (ref.flash_attention_ref(pq, pk, pv) * do).sum(), (pq, pk, pv))
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, **GRAD_TOL)


def test_flash_without_grad_saves_nothing_and_takes_the_plain_call():
    q, k, v, _ = (_t(a) for a in _flash_inputs(4, 1, 32, 32, 4, 2, 32, 32))
    q.requires_grad_(True)
    with torch.no_grad():
        out = fa_mod.flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v),
                               atol=0, rtol=0)
    q.requires_grad_(False)
    assert fa_mod.flash_attention(q, k, v).grad_fn is None


# ------------------------------------------------------------------ rmsnorm

@pytest.mark.parametrize("x_dtype,tol", [("float32", 1e-5),
                                         ("bfloat16", 3e-2)])
def test_rmsnorm_gradient_matches_the_reference(x_dtype, tol):
    """The Function's closed-form gradient against jax.grad of the
    reference's oracle, with an f32 scale (bf16 x: the mixed case)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 96), dtype=np.float32)
    g = rng.standard_normal(96, dtype=np.float32)
    w = rng.standard_normal((3, 7, 96), dtype=np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    exp = jax.grad(lambda x, g: (jax_ref.rmsnorm_ref(x, g).astype(
        jnp.float32) * jnp.asarray(w)).sum(), argnums=(0, 1))(jx, jnp.asarray(g))
    tdt = getattr(torch, x_dtype)
    tx = _t(x).to(tdt).requires_grad_(True)
    tg = _t(g, True)
    y = rms_mod.rmsnorm(tx, tg)
    assert type(y.grad_fn).__name__.startswith("RMSNorm")
    got = torch.autograd.grad((y.float() * _t(w)).sum(), (tx, tg))
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    for a, e in zip(got, exp):
        np.testing.assert_allclose(_np(a), np.asarray(e, np.float32),
                                   atol=tol, rtol=tol)


def test_rmsnorm_gradient_matches_autodiff_of_the_plain_version():
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((5, 64), dtype=np.float32), True)
    g = _t(rng.standard_normal(64, dtype=np.float32), True)
    w = _t(rng.standard_normal((5, 64), dtype=np.float32))
    got = torch.autograd.grad((rms_mod.rmsnorm(x, g) * w).sum(), (x, g))
    exp = torch.autograd.grad((ref.rmsnorm_ref(x, g) * w).sum(), (x, g))
    for a, e in zip(got, exp):
        torch.testing.assert_close(a, e, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("call", [
    lambda t: da_mod.decode_attention(t[None, :1, None], t[None, :, None],
                                      t[None, :, None], 8),
    lambda t: ms_mod.mamba_scan(t[None], t[None], t[None], t[None], t,
                                t[None]),
], ids=["decode_attention", "mamba_scan"])
def test_plain_decode_and_scan_stay_differentiable_on_the_cpu(call):
    """On the CPU the plain versions carry gradients (the scan's through
    MambaScan's plain backward); on CUDA decode attention refuses under
    grad and the scan launches its backward kernel
    (tests/test_torch_gpu.py)."""
    t = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    t.requires_grad_(True)
    out = call(t)
    out = out[0] if isinstance(out, tuple) else out
    (grad,) = torch.autograd.grad(out.sum(), t)
    assert torch.isfinite(grad).all()


# --------------------------------------------------------------------- loss

@pytest.fixture(scope="module")
def built():
    """arch -> (JAX model, JAX params, port model, numpy params)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jmodel = jax_build_model(jax_get_smoke(arch))
            jparams = jmodel.init(jax.random.PRNGKey(0))
            cache[arch] = (jmodel, jparams, build_model(get_smoke(arch),
                                                        "cpu"),
                           jax.tree.map(np.asarray, jparams))
        return cache[arch]
    return get


def _batch(cfg, seed, b, s, mask: bool):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) > 0.3).astype(np.float32)
    return out


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _port_loss_and_grads(model, params, batch):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    return loss.detach(), torch.autograd.grad(loss, flat, allow_unused=True,
                                              materialize_grads=True)


def _assert_leaves_close(got, jtree, rel=LEAF_REL):
    """Every port leaf against the JAX leaf on the same path, within
    ``rel`` of the JAX leaf's largest entry."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(jflat) == len(got)
    for (path, e), g in zip(jflat, got):
        e = np.asarray(e, np.float32)
        scale = max(float(np.abs(e).max()), 1e-30)
        err = float(np.abs(_np(g) - e).max())
        assert err <= rel * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("mask", [False, True], ids=["mean", "loss_mask"])
@pytest.mark.parametrize("arch", LOSS_ARCHES)
def test_loss_and_every_gradient_match_the_reference(built, arch, mask):
    """Model.loss and its gradient for every leaf; deepseek's aux holds
    its routers' loss and the MTP loss; the -sw config's window 64 bites
    at 80 tokens; Jamba's Mamba layers carry the scan's state and its
    gradient across two chunks."""
    jmodel, jparams, model, nparams = built(arch)
    seq = LOSS_SEQ.get(arch, 24)
    batch = _batch(model.cfg, 7, 2, seq, mask)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(nparams, "cpu")
    loss, grads = _port_loss_and_grads(model, params, _to_torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    _assert_leaves_close(grads, jgrads, LEAF_REL_ARCH.get(arch, LEAF_REL))
    if model.cfg.mtp_depth:
        # the aux carries the MTP loss: its leaves get gradient
        mtp = [g for (k, _), g in zip(flatten_with_path(params), grads)
               if k.startswith("['mtp']")]
        assert mtp and all(float(g.abs().max()) > 0 for g in mtp)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_remat_gives_the_same_loss_and_gradients(built, arch):
    _, _, model, nparams = built(arch)
    batch = _to_torch(_batch(model.cfg, 8, 2, 24, mask=False))
    results = []
    for remat in (False, True):
        m = build_model(dataclasses.replace(model.cfg, remat=remat), "cpu")
        results.append(_port_loss_and_grads(
            m, params_from_numpy(nparams, "cpu"), batch))
    (l0, g0), (l1, g1) = results
    assert float(l0) == float(l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_loss_mask_of_zeros_divides_by_one(built):
    _, _, model, nparams = built("llama3.2-1b")
    batch = _to_torch(_batch(model.cfg, 9, 2, 16, mask=True))
    batch["loss_mask"] = torch.zeros_like(batch["loss_mask"])
    with torch.no_grad():
        loss = model.loss(params_from_numpy(nparams, "cpu"), batch)
    assert float(loss) == 0.0


# ---------------------------------------------------------------- optimizer

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"embed": rng.standard_normal((6, 4), dtype=np.float32),
            "segments": ({"w": rng.standard_normal((2, 4, 3),
                                                   dtype=np.float32),
                          "scale": rng.standard_normal((2, 4),
                                                       dtype=np.float32)},),
            "bias": rng.standard_normal(5, dtype=np.float32)}
    return tree


def _grads_like(tree, seed, size):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * size)
                        .astype(np.float32), tree)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("clip,size", [(1.0, 0.01), (0.5, 3.0)],
                         ids=["clip-inactive", "clip-active"])
def test_adamw_update_matches_the_reference(moment_dtype, clip, size):
    """Two updates from identical gradients: parameters, moments and the
    step against the reference's, with f32 and bf16 moments and with the
    global-norm clip inactive and active."""
    kw = dict(lr=1e-2, moment_dtype=moment_dtype, grad_clip=clip)
    tree = _opt_tree(10)
    jopt, opt = JaxAdamW(**kw), AdamW(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = params_from_numpy(tree, "cpu")
    ts = opt.init(tp)
    assert ts.step.dtype == torch.int32
    gnorms = []
    for i in range(2):
        g = _grads_like(tree, 20 + i, size)
        gnorms.append(math.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                                    for x in jax.tree.leaves(g))))
        jp, js = jopt.update(jp, js, jax.tree.map(jnp.asarray, g))
        tp2, ts2 = opt.update(tp, ts, params_from_numpy(g, "cpu"))
        assert tp2 is tp and ts2.mu is ts.mu     # in place
        tp, ts = tp2, ts2
    assert (max(gnorms) > clip) == (size > 1)
    assert int(ts.step) == int(js.step) == 2
    for got, exp in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        jflat = jax.tree.leaves(exp)
        for g, e in zip(leaves(got), jflat):
            assert str(g.dtype)[6:] == str(e.dtype)
            np.testing.assert_allclose(_np(g), np.asarray(e, np.float32),
                                       **OPT_TOL)


def test_adamw_decays_matrices_only():
    opt = AdamW(lr=0.1, weight_decay=0.5, grad_clip=0.0)
    tree = {"m": torch.ones(2, 2), "v": torch.ones(2)}
    state = opt.init(tree)
    opt.update(tree, state, {"m": torch.zeros(2, 2), "v": torch.zeros(2)})
    torch.testing.assert_close(tree["m"], torch.full((2, 2), 0.95))
    torch.testing.assert_close(tree["v"], torch.ones(2))


# --------------------------------------------------------------------- step

class _Recording:
    """An optimizer that records the gradients it is handed and leaves
    the parameters as they are (both frameworks' steps call only
    ``update``)."""

    def __init__(self):
        self.grads = None

    def update(self, params, state, grads, sq_norm=None):
        self.grads = grads
        return params, state


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference_loss_and_gradients(built,
                                                             microbatches):
    jmodel, jparams, model, nparams = built("llama3.2-1b")
    batch = _batch(model.cfg, 11, 4, 24, mask=True)
    jrec, rec = _Recording(), _Recording()
    _, _, jm = jax_make_train_step(jmodel, jrec, microbatches)(
        jparams, None, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(nparams, "cpu")
    out_params, _, m = make_train_step(model, rec, microbatches)(
        params, None, _to_torch(batch))
    assert out_params is params
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=1e-5)
    _assert_leaves_close(leaves(rec.grads), jrec.grads)


def test_train_step_with_adamw_updates_in_place_and_lowers_the_loss(built):
    _, _, model, nparams = built("llama3.2-1b")
    params = params_from_numpy(nparams, "cpu")
    before = [p.detach().clone() for p in leaves(params)]
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    step = make_train_step(model, opt)
    batch = _to_torch(_batch(model.cfg, 12, 2, 24, mask=False))
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves(params)))
    assert losses[-1] < losses[0]


def test_trainer_fit_lowers_the_loss_on_a_smoke_config():
    model = build_model(get_smoke("llama3.2-1b"), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    seen = []
    params, state, losses = Trainer(model, AdamW(lr=3e-3), log_every=0).fit(
        params, data.batches(model.cfg, 4, 32, seed=0), steps=8,
        callback=lambda i, loss: seen.append((i, loss)))
    assert seen == list(enumerate(losses)) and len(losses) == 8
    assert all(math.isfinite(x) for x in losses)
    assert np.mean(losses[-3:]) < losses[0]
    assert isinstance(state, AdamWState) and int(state.step) == 8


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-small",
                                  "pixtral-12b"])
def test_batches_equal_the_reference(arch):
    ours = list(data.batches(get_smoke(arch), 3, 20, seed=4, steps=3))
    theirs = list(jax_data.batches(jax_get_smoke(arch), 3, 20, seed=4,
                                   steps=3))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# -------------------------------------------------------------- checkpoints

def _state_trees():
    """Params with a bf16 leaf, and an AdamW state with bf16 moments, as
    numpy trees."""
    tree = _opt_tree(30)
    tree["segments"][0]["w"] = jnp.asarray(
        tree["segments"][0]["w"]).astype(jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = JaxAdamW(lr=1e-2, moment_dtype="bfloat16")
    js = jopt.init(jp)
    jp, js = jopt.update(jp, js, jax.tree.map(jnp.asarray,
                                              _grads_like(tree, 31, 0.1)))
    return jp, js


def _port_state(jp, js):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), \
        AdamWState(torch.tensor(int(js.step), dtype=torch.int32),
                   params_from_numpy(jax.tree.map(np.asarray, js.mu), "cpu"),
                   params_from_numpy(jax.tree.map(np.asarray, js.nu), "cpu"))


def _same(got_tree, exp_tree):
    got = flatten_with_path(got_tree)
    exp = jax.tree_util.tree_flatten_with_path(exp_tree)[0]
    assert [k for k, _ in got] == ["/".join(str(p) for p in path)
                                   for path, _ in exp]
    for (_, g), (_, e) in zip(got, exp):
        g = g.detach() if isinstance(g, torch.Tensor) else torch.as_tensor(
            np.asarray(g))
        e = np.asarray(e)
        if e.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.uint16).numpy(),
                                  e.view(np.uint16))
        else:
            assert np.array_equal(np.asarray(g), e) and \
                str(g.dtype)[6:] == str(e.dtype)


def test_checkpoints_round_trip_both_ways(tmp_path):
    jp, js = _state_trees()
    tp, ts = _port_state(jp, js)
    for jtree, ttree in ((jp, tp), (js, ts)):
        # JAX saves, the port restores
        path = str(tmp_path / "jax.npz")
        jax_ckpt.save(path, jtree)
        _same(checkpoint.restore(path, ttree), jtree)
        # the port saves, JAX restores; the files hold the same keys
        path2 = str(tmp_path / "torch.npz")
        checkpoint.save(path2, ttree)
        _same(ttree, jax_ckpt.restore(path2, jtree))
        with np.load(path) as a, np.load(path2) as b:
            assert sorted(a.files) == sorted(b.files)
            assert any(k.startswith("__bf16__") for k in a.files)
    # the key forms: a dict key, a tuple index, a NamedTuple field
    with np.load(str(tmp_path / "torch.npz")) as f:
        assert ".step" in f.files
        assert "__bf16__.mu/['segments']/[0]/['w']" in f.files


def test_restore_raises_on_a_mismatch(tmp_path):
    jp, js = _state_trees()
    tp, _ = _port_state(jp, js)
    path = str(tmp_path / "p.npz")
    checkpoint.save(path, tp)
    extra = dict(tp, more=torch.zeros(2))
    with pytest.raises(ValueError, match="missing"):
        checkpoint.restore(path, extra)
    fewer = {k: v for k, v in tp.items() if k != "bias"}
    with pytest.raises(ValueError, match="extra"):
        checkpoint.restore(path, fewer)
    wrong = dict(tp, bias=torch.zeros(6))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, wrong)
