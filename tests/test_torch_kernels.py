"""The port's kernel layer on the CPU: its plain versions against the JAX
reference's Pallas kernels run in interpret mode, and its dispatch
rules. The CUDA kernels themselves run only on a GPU
(tests/test_torch_gpu.py).

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances are the repo's kernel tolerances (tests/test_kernels.py):
f32 2e-5/2e-5, bf16 3e-2/3e-2.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import xla_flash  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as ms_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.models import parallel  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(TORCH_DTYPE[dtype]))


def _close(got: torch.Tensor, exp, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **TOL[dtype])


# ------------------------------------------------------------------ rmsnorm

@pytest.mark.parametrize("shape,block_rows", [
    ((3, 5, 384), 256),
    ((7, 320), 4),          # ragged rows: the TPU kernel's row-at-a-time path
    ((2, 32, 768), 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_interpret(shape, block_rows, dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal(shape[-1:], dtype=np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    exp = jax_rmsnorm(jx, jg, block_rows=block_rows, interpret=True)
    got = ops.rmsnorm(tx, tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, exp, dtype)


# ------------------------------------------------------------------- flash

FLASH_CASES = [
    # (b, sq, sk, h, kv, d, dv, causal, window)
    pytest.param(1, 64, 64, 4, 4, 32, 32, True, 0, id="mha-causal"),
    pytest.param(2, 64, 64, 4, 2, 32, 32, True, 0, id="gqa-causal"),
    pytest.param(1, 64, 64, 4, 1, 32, 32, True, 0, id="mqa-causal"),
    pytest.param(1, 32, 64, 4, 2, 32, 32, False, 0, id="gqa-full-sq<sk"),
    pytest.param(1, 32, 96, 4, 2, 32, 32, True, 0, id="causal-sq<sk"),
    pytest.param(1, 64, 64, 4, 2, 32, 32, True, 16, id="window16"),
    pytest.param(1, 32, 32, 4, 2, 64, 32, True, 0, id="d!=dv"),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas_interpret(b, sq, sk, h, kv, d, dv,
                                              causal, window):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, kv, dv), dtype=np.float32)
    exp = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                   window=window), exp, "float32")
    kind = "causal" if causal else "full"
    _close(ops.attention(tq, tk, tv, None, torch.float32, kind=kind,
                         window=window), exp, "float32")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), nearest with ties away from
    zero, by bit mask: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int):
    """a @ b with TF32 inputs and f32 accumulation, as the tensor cores
    compute it: one pass (big @ big) or the kernel's 3xTF32 split
    (small @ big + big @ small + big @ big, small = a - big). A TF32
    product is exact in f32, so an f32 matmul of TF32 values stands for
    the MMA."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    # the remainder as the MMA reads it: its top 19 bits, truncated
    as_, bs = (((r.contiguous().view(torch.int32) & ~0x1FFF)
                .view(torch.float32)) for r in (a - ab, b - bb))
    return as_ @ bb + ab @ bs + ab @ bb


def _flash_tf32(q, k, v, causal, window, passes):
    """The f32 flash kernel's arithmetic in plain torch: scores and P V
    through TF32 products, softmax in f32 (one tile: the online
    rescaling is exact up to f32 rounding)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)   # b kv g sq d
    kt = k.permute(0, 2, 3, 1)[:, :, None]                     # b kv 1 d sk
    vt = v.permute(0, 2, 1, 3)[:, :, None]                     # b kv 1 sk dv
    s = _tf32_matmul(qg, kt, passes) / np.sqrt(d)
    if causal:
        mask = ref.causal_mask_ref(sq, k.shape[1], window,
                                   offset=k.shape[1] - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = _tf32_matmul(p, vt, passes)                          # b kv g sq dv
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, v.shape[-1])


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", FLASH_CASES
                         + [pytest.param(1, 128, 128, 8, 2, 128, 128, True,
                                         0, id="hybrid-d128"),
                            pytest.param(1, 64, 64, 4, 4, 192, 128, True, 0,
                                         id="mla-d192-dv128")])
def test_flash_3xtf32_split_meets_the_f32_bar(b, sq, sk, h, kv, d, dv,
                                             causal, window):
    """Why the f32 kernel takes three TF32 passes per product: the split
    meets the repo's f32 bar (2e-5/2e-5) against the plain version, one
    TF32 pass does not."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, dv)))
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    split = _flash_tf32(q, k, v, causal, window, passes=3)
    torch.testing.assert_close(split, exp, **TOL["float32"])
    one = _flash_tf32(q, k, v, causal, window, passes=1)
    assert not torch.allclose(one, exp, **TOL["float32"])
    assert float((one - exp).abs().max()) > 10 * float(
        (split - exp).abs().max())


def _flash_bwd_tf32(q, k, v, out, lse, do, causal, window, passes):
    """The f32 backward kernel's arithmetic in plain torch: its five
    products (S, dP, dV, dK, dQ) through TF32 products, P = exp(S - lse)
    and dS = P (dP - delta) in f32; dK and dV sum the GQA group inside one
    product over its packed rows, as the kernel's q tiles do."""
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    scale = 1.0 / np.sqrt(d)
    qg = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)    # b kv g sq d
    dog = do.reshape(b, sq, kvh, g, dv).permute(0, 2, 3, 1, 4)
    kr = k.permute(0, 2, 1, 3)[:, :, None]                      # b kv 1 sk d
    vr = v.permute(0, 2, 1, 3)[:, :, None]                      # b kv 1 sk dv
    rows = lambda x: x.reshape(b, sq, kvh, g).permute(0, 2, 3, 1)[..., None]  # noqa: E731
    s = _tf32_matmul(qg, kr.transpose(-1, -2), passes) * scale
    p = torch.exp(s - rows(lse))          # 0 where lse is +inf
    if causal:
        p = p.masked_fill(~ref.causal_mask_ref(sq, sk, window,
                                               offset=sk - sq), 0.0)
    dp = _tf32_matmul(dog, vr.transpose(-1, -2), passes)
    ds = p * (dp - rows((do * out).sum(-1)))
    dq = _tf32_matmul(ds, kr, passes) * scale                   # b kv g sq d
    # the group's packed rows as one inner dim: (b, kv, sk, g sq)
    packed = lambda x: x.permute(0, 1, 4, 2, 3).reshape(b, kvh, sk, g * sq)  # noqa: E731
    dk = _tf32_matmul(packed(ds), qg.reshape(b, kvh, g * sq, d),
                      passes) * scale
    dvv = _tf32_matmul(packed(p), dog.reshape(b, kvh, g * sq, dv), passes)
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d),
            dk.permute(0, 2, 1, 3), dvv.permute(0, 2, 1, 3))


BWD_TOL = dict(atol=5e-4, rtol=5e-4)   # the backward's bar on the card


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window,vjp", [
    pytest.param(2, 256, 256, 4, 4, 64, 64, True, 0, True, id="causal-G1"),
    pytest.param(2, 128, 384, 4, 2, 64, 64, True, 0, False, id="sq<sk-G2"),
    pytest.param(2, 256, 256, 4, 1, 64, 64, False, 0, False, id="full-G4"),
    pytest.param(2, 256, 256, 8, 2, 64, 64, True, 64, False,
                 id="window64-G4"),
    pytest.param(2, 100, 200, 4, 2, 64, 64, True, 0, False,
                 id="ragged-100x200"),
    pytest.param(2, 37, 37, 6, 2, 32, 32, False, 0, False, id="G3-full"),
    pytest.param(1, 70, 90, 6, 3, 64, 32, True, 16, False,
                 id="d!=dv-window"),
    pytest.param(1, 48, 16, 4, 1, 32, 32, True, 0, False, id="sq>sk-blind"),
    pytest.param(1, 64, 96, 4, 4, 192, 128, True, 0, False,
                 id="mla-d192-dv128"),
])
def test_flash_bwd_3xtf32_split_meets_the_backward_bar(b, sq, sk, h, kv, d,
                                                       dv, causal, window,
                                                       vjp):
    """Why the f32 backward kernel takes three TF32 passes per product: the
    split meets the backward's bar (5e-4/5e-4) against the plain version
    (and, on one case, against jax.vjp of the reference's custom VJP);
    one TF32 pass misses it, at least 10x further from the plain
    version."""
    rng = np.random.default_rng(6)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape,
                                                        dtype=np.float32))
                   for shape in ((b, sq, h, d), (b, sk, kv, d),
                                 (b, sk, kv, dv), (b, sq, h, dv)))
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    exp = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    split = _flash_bwd_tf32(q, k, v, out, lse, do, causal, window, passes=3)
    one = _flash_bwd_tf32(q, k, v, out, lse, do, causal, window, passes=1)
    for s, o, e in zip(split, one, exp):
        torch.testing.assert_close(s, e, **BWD_TOL)
        assert float((o - e).abs().max()) > 10 * float((s - e).abs().max())
    assert not all(torch.allclose(o, e, **BWD_TOL) for o, e in zip(one, exp))
    if vjp:
        _, pull = jax.vjp(lambda a, bb, c: xla_flash.flash_attention_xla(
            a, bb, c, causal=causal, window=window),
            *(jnp.asarray(t.numpy()) for t in (q, k, v)))
        for s, e in zip(split, pull(jnp.asarray(do.numpy()))):
            np.testing.assert_allclose(s.numpy(), np.asarray(e), **BWD_TOL)


def test_flash_plain_matches_pallas_interpret_bf16():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 64, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 64, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 64, 2, 32), dtype=np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (q, k, v))
    exp = jax_flash(jq, jk, jv, causal=True, interpret=True)
    got = ops.attention(tq, tk, tv, None, torch.bfloat16, kind="causal")
    assert got.dtype == torch.bfloat16
    _close(got, exp, "bfloat16")


@pytest.mark.parametrize("mask_shape", [(32, 48), (1, 4, 32, 48)],
                         ids=["shared", "per-head"])
def test_explicit_mask_matches_reference(mask_shape):
    """Irregular masks (kind None) take the plain path on the CPU; rows
    with every key masked give 0 in both frameworks."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 32, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 48, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 48, 2, 16), dtype=np.float32)
    mask = rng.random(mask_shape) < 0.5
    mask[..., 3, :] = False                   # one fully masked row
    exp = jax_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask))
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(mask),
                        torch.float32, kind=None)
    _close(got, exp, "float32")
    assert float(got[:, 3].abs().max()) == 0.0


# ---------------------------------------------------------------- dispatch

def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    q = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(1))
    before = (rms_mod.counter.count, fa_mod.counter.count,
              da_mod.counter.count, ms_mod.counter.count)
    torch.testing.assert_close(ops.rmsnorm(x, torch.ones(64)),
                               ref.rmsnorm_ref(x, torch.ones(64)),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ops.attention(q, q, q, None, torch.float32, kind="causal"),
        ref.flash_attention_ref(q, q, q), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.attention(q[:, :1], q, q, None, torch.float32, kind="decode",
                      valid_len=5),
        ref.decode_attention_ref(q[:, :1], q, q, 5), rtol=0, atol=0)
    dt = torch.rand(1, 6, 16, generator=torch.Generator().manual_seed(2))
    bc = torch.randn(1, 6, 8, generator=torch.Generator().manual_seed(3))
    a, h0 = -torch.ones(16, 8), torch.zeros(1, 16, 8)
    for got, exp in zip(ops.mamba_chunk(dt, dt, bc, bc, a, h0),
                        ref.mamba_scan_ref(dt, dt, bc, bc, a, h0)):
        torch.testing.assert_close(got, exp, rtol=0, atol=0)
    assert (rms_mod.counter.count, fa_mod.counter.count,
            da_mod.counter.count, ms_mod.counter.count) == before


@pytest.mark.parametrize("call", [
    lambda t: rms_mod.rmsnorm(t, t[0]),
    lambda t: fa_mod.flash_attention(t[None, :, None], t[None, :, None],
                                     t[None, :, None]),
    lambda t: da_mod.decode_attention(t[None, :1, None], t[None, :, None],
                                      t[None, :, None], 8),
    lambda t: ms_mod.mamba_scan(t[None], t[None], t[None], t[None], t,
                                t[None]),
    lambda t: fa_mod.flash_attention_backward(
        t[None, :, None], t[None, :, None], t[None, :, None],
        t[None, :, None], t[None, :, :1], t[None, :, None]),
    # the autograd Functions: an input that requires grad
    lambda t: rms_mod.rmsnorm(t.requires_grad_(True), t[0]),
    lambda t: fa_mod.flash_attention(
        t.requires_grad_(True)[None, :, None], t[None, :, None],
        t[None, :, None]),
], ids=["rmsnorm", "flash_attention", "decode_attention", "mamba_scan",
        "flash_attention_backward", "rmsnorm-grad", "flash_attention-grad"])
def test_other_devices_raise_instead_of_falling_back(call):
    with pytest.raises(ValueError, match="unsupported device"):
        call(torch.empty((8, 8), device="meta"))


@pytest.mark.parametrize("call,what", [
    # xLSTM decodes on one rank now; sharding its cells is what is missing
    (lambda: parallel._supported(get_smoke("xlstm-125m")), "A11b"),
], ids=["decode"])
def test_later_slices_raise_not_implemented(call, what):
    with pytest.raises(NotImplementedError, match=what):
        call()


def test_launch_counter_counts_every_thread():
    """The wrappers count launches without a lock: adds from several
    threads at once are all counted, and reset starts again at 0."""
    import threading
    counter = _build.LaunchCounter()
    threads = [threading.Thread(
        target=lambda: [counter.add() for _ in range(20_000)])
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.count == 80_000
    counter.reset()
    assert counter.count == 0
    counter.add()
    assert counter.count == 1


def test_entry_loads_and_binds_once(monkeypatch):
    """``_build.entry`` loads the library on its first call only; later
    calls return the same bound function."""
    loads = []

    class FakeLib:
        def rmsnorm_f32(self, *args):
            return 0

    def fake_load():
        loads.append(1)
        return FakeLib()

    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "load", fake_load)
    first = _build.entry("rmsnorm_f32")
    assert _build.entry("rmsnorm_f32") is first
    assert len(loads) == 1


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_every_cuda_source_is_built_and_every_export_declared():
    """One nvcc call builds every csrc/*.cu; each C entry point the
    wrappers call has a ctypes signature (pointers as c_void_p)."""
    names = {p.name for p in _build.sources()}
    assert {"rmsnorm.cu", "flash_attention.cu", "flash_attention_bwd.cu",
            "decode_attention.cu", "mamba_scan.cu"} <= names
    text = "".join(p.read_text() for p in _build.sources())
    for fn, (argtypes, _) in _build.SIGNATURES.items():
        assert f'extern "C"' in text and f" {fn}(" in text, fn
    for fn in ("rmsnorm_f32", "rmsnorm_bf16", "flash_attention_fwd",
               "flash_attention_bwd", "decode_attention_fwd",
               "mamba_scan_fwd"):
        argtypes = _build.SIGNATURES[fn][0]
        assert argtypes[0] is _build.ctypes.c_void_p
        assert argtypes[-1] is _build.ctypes.c_void_p        # the stream


def test_meta_branch_gives_true_shapes_and_counts_the_work():
    """Inside ``meta.shapes_only`` (the dry-run) the wrappers take meta
    tensors: outputs of the kernels' true shapes and dtypes, flash's
    logsumexp only under grad and never an S x S tensor, and the
    kernels' FLOPs counted (flash: 2 (D + Dv) a kept pair; the backward
    2 (4 D + 3 Dv); decode: 2 (D + Dv) a valid slot). No counter moves."""
    from repro_torch.kernels import meta
    m = dict(device="meta")
    before = (rms_mod.counter.count, fa_mod.counter.count,
              fa_mod.bwd_counter.count, da_mod.counter.count)
    with meta.shapes_only():
        x = torch.empty(6, 64, **m)
        assert rms_mod.rmsnorm(x, torch.empty(64, **m)).shape == (6, 64)
        assert meta.flops() == 4 * 6 * 64
        q = torch.empty(2, 8, 4, 64, **m)
        k = torch.empty(2, 8, 2, 64, **m)
        v = torch.empty(2, 8, 2, 32, **m)
        out = fa_mod.flash_attention(q, k, v)
        assert out.shape == (2, 8, 4, 32) and out.is_meta
        pairs = meta.attention_pairs(2, 8, 8, 4, True, 0)
        assert pairs == 2 * 4 * 36
        assert meta.flops() == 4 * 6 * 64 + 2 * pairs * 96
        out, lse = fa_mod.flash_attention_with_lse(q, k, v, causal=False)
        assert lse.shape == (2, 8, 4) and lse.dtype == torch.float32
        qg = q.clone().requires_grad_(True)
        fa_mod.flash_attention(qg, k, v).sum().backward()
        assert qg.grad.shape == q.shape
        n0 = meta.flops()
        d = da_mod.decode_attention(q[:, :1], k, v, 5)
        assert d.shape == (2, 1, 4, 32)
        assert meta.flops() - n0 == 2 * 2 * 4 * 5 * 96
    assert not meta.enabled() and meta.flops() == 0.0
    assert (rms_mod.counter.count, fa_mod.counter.count,
            fa_mod.bwd_counter.count, da_mod.counter.count) == before


def test_flash_with_lse_is_the_plain_forward_and_its_logsumexp():
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 4, 32, generator=g)
    k = torch.randn(2, 9, 2, 32, generator=g)
    v = torch.randn(2, 9, 2, 32, generator=g)
    out, lse = fa_mod.flash_attention_with_lse(q, k, v, causal=False)
    exp_out, exp_lse = ref.flash_attention_ref(q, k, v, causal=False,
                                               return_lse=True)
    torch.testing.assert_close(out, exp_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, exp_lse, rtol=0, atol=0)
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(2, dim=2)) / math.sqrt(32)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).transpose(1, 2),
                               atol=1e-5, rtol=1e-5)
