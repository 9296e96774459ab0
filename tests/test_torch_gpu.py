"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU and the CUDA toolkit (the kernels have
no CPU mode) and skips without one. The module imports no JAX, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu -p no:cacheprovider tests/test_torch_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("rows,d", [(32, 768), (512, 2048), (7, 2048),
                                    (3, 4096), (5, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(gen, rows, d, dtype):
    x, g = _rand(gen, (rows, d), dtype), _rand(gen, (d,), dtype)
    before = rms_mod.counter.count
    got = rms_mod.rmsnorm(x, g)
    torch.cuda.synchronize()
    assert rms_mod.counter.count == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, g).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", [
    (8, 32, 32, 32, 8, 64, 64, True, 0),       # llama3.2-1b served shape
    (1, 64, 160, 32, 8, 64, 64, True, 0),      # Sq < Sk
    (2, 96, 96, 8, 2, 64, 64, True, 16),       # window
    (1, 64, 64, 4, 2, 128, 64, True, 0),       # D != Dv
    (2, 40, 40, 4, 2, 64, 64, True, 0),        # ragged
    (1, 32, 96, 4, 4, 64, 64, False, 0),       # full
    (1, 48, 16, 4, 1, 32, 32, True, 0),        # Sq > Sk: early rows see no key
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(gen, b, sq, sk, h, kv, d, dv, causal,
                                    window, dtype):
    q = _rand(gen, (b, sq, h, d), dtype)
    k = _rand(gen, (b, sk, kv, d), dtype)
    v = _rand(gen, (b, sk, kv, dv), dtype)
    before = fa_mod.counter.count
    got = fa_mod.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_mod.counter.count == before + 1
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), exp.float(), **TOL[dtype])


def test_kernels_reject_what_they_do_not_take(gen):
    x = _rand(gen, (4, 6), torch.float32)
    with pytest.raises(ValueError, match="multiple of 4"):
        rms_mod.rmsnorm(x, x[0])
    with pytest.raises(TypeError):
        rms_mod.rmsnorm(x.double(), x[0].double())
    q = _rand(gen, (1, 8, 2, 192), torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        fa_mod.flash_attention(q, q, q)
    q = _rand(gen, (1, 8, 2, 16), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa_mod.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                               q.transpose(1, 2))
