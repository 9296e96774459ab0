"""The port's kernel layer on the CPU: its plain versions against the JAX
reference's Pallas kernels run in interpret mode, and its dispatch
rules. The CUDA kernels themselves run only on a GPU
(tests/test_torch_gpu.py).

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances are the repo's kernel tolerances (tests/test_kernels.py):
f32 2e-5/2e-5, bf16 3e-2/3e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402

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
    before = (rms_mod.counter.count, fa_mod.counter.count)
    torch.testing.assert_close(ops.rmsnorm(x, torch.ones(64)),
                               ref.rmsnorm_ref(x, torch.ones(64)),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ops.attention(q, q, q, None, torch.float32, kind="causal"),
        ref.flash_attention_ref(q, q, q), rtol=0, atol=0)
    assert (rms_mod.counter.count, fa_mod.counter.count) == before


@pytest.mark.parametrize("call", [
    lambda t: rms_mod.rmsnorm(t, t[0]),
    lambda t: fa_mod.flash_attention(t[None, :, None], t[None, :, None],
                                     t[None, :, None]),
], ids=["rmsnorm", "flash_attention"])
def test_other_devices_raise_instead_of_falling_back(call):
    with pytest.raises(ValueError, match="unsupported device"):
        call(torch.empty((8, 8), device="meta"))


@pytest.mark.parametrize("call,what", [
    (lambda: ops.attention(*(torch.zeros(1, 1, 2, 8),) * 3, None,
                           torch.float32, kind="decode"), "decode slice"),
    (lambda: ops.mamba_chunk(*(None,) * 6), "SSM/hybrid slice"),
], ids=["decode", "mamba"])
def test_later_slices_raise_not_implemented(call, what):
    with pytest.raises(NotImplementedError, match=what):
        call()


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_every_cuda_source_is_built_and_every_export_declared():
    """One nvcc call builds every csrc/*.cu; each C entry point the
    wrappers call has a ctypes signature (pointers as c_void_p)."""
    names = {p.name for p in _build.sources()}
    assert {"rmsnorm.cu", "flash_attention.cu"} <= names
    text = "".join(p.read_text() for p in _build.sources())
    for fn, (argtypes, _) in _build.SIGNATURES.items():
        assert f'extern "C"' in text and f" {fn}(" in text, fn
    for fn in ("rmsnorm_f32", "rmsnorm_bf16", "flash_attention_fwd"):
        argtypes = _build.SIGNATURES[fn][0]
        assert argtypes[0] is _build.ctypes.c_void_p
        assert argtypes[-1] is _build.ctypes.c_void_p        # the stream
