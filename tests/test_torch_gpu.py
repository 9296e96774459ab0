"""The port's CUDA kernels against their plain versions, on the card,
and the stages built on them: their CUDA graphs, replica slots and
worker processes (one card and, where the host has them, two).

Every test here needs a CUDA GPU and the CUDA toolkit (the kernels have
no CPU mode) and skips without one. The module imports no JAX, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu -p no:cacheprovider tests/test_torch_gpu.py
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke, without_experts  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as ms_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    PipelineConfig,
    StageConfig,
    linear_pipeline,
)
from repro_torch.faults import FaultSchedule, crash  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SEQ,
    PipelineExecutor,
    ProcessReplicaPool,
    ProcessStage,
    make_stage,
    worker_counts,
)
from repro_torch.serving import stage as stage_mod  # noqa: E402

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
                                    (3, 4096), (5, 4),
                                    # a CTA per row past D 4096
                                    (9, 8192), (3, 4100), (2, 16384),
                                    # a CTA per row below 528 rows, a warp
                                    # per row from there
                                    (1, 2048), (7, 768), (256, 2048),
                                    (256, 768), (527, 4096), (528, 2048),
                                    (4096, 2048), (4096, 8192)])
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
    (2, 512, 512, 64, 8, 128, 128, True, 0),   # the hybrid's attention
    # q tiles hold position x G rows of one kv head's group
    (2, 64, 64, 8, 8, 64, 64, True, 0),        # G = 1
    (2, 64, 64, 16, 4, 64, 64, True, 0),       # G = 4
    (2, 64, 64, 64, 8, 128, 128, True, 0),     # G = 8
    (2, 37, 37, 6, 2, 64, 64, True, 0),        # G = 3: 111 rows, ragged tile
    (1, 5, 5, 12, 1, 64, 64, True, 0),         # G = 12: one tile, 60 of 64 rows
    (1, 50, 120, 8, 2, 64, 64, True, 24),      # Sq < Sk with a window
    (1, 40, 100, 8, 4, 64, 128, True, 16),     # D != Dv, Dv > D, windowed
    (2, 33, 33, 4, 2, 32, 64, False, 0),       # D != Dv, full
    (8, 512, 512, 32, 8, 64, 64, True, 0),     # llama3.2-1b prefill
    (8, 512, 512, 64, 8, 128, 128, True, 0),   # the hybrid's prefill
    # DeepSeek-V3's MLA: D 192 (128 + 64 RoPE dims), Dv 128, G 1 at H 128
    (8, 32, 32, 128, 128, 192, 128, True, 0),  # scoring
    (2, 512, 512, 128, 128, 192, 128, True, 0),  # prefill
    (2, 77, 200, 128, 128, 192, 128, True, 0),   # ragged, Sq < Sk
    (1, 64, 64, 8, 8, 192, 128, False, 0),     # full
    (2, 40, 40, 16, 4, 136, 64, True, 0),      # D in (128, 192], G 4
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


def test_second_call_uses_the_cached_binding(gen, monkeypatch):
    """After the first launch, a wrapper call neither builds nor loads
    the library again: the bound entry point is reused."""
    x, g = _rand(gen, (4, 64), torch.float32), _rand(gen, (64,),
                                                     torch.float32)
    q = _rand(gen, (1, 8, 4, 64), torch.float32)
    rms_mod.rmsnorm(x, g)
    fa_mod.flash_attention(q, q, q)
    bound = dict(_build._entries)

    def refuse(*args, **kwargs):
        raise AssertionError("the library was built or loaded again")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = (rms_mod.counter.count, fa_mod.counter.count)
    got = rms_mod.rmsnorm(x, g)
    out = fa_mod.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert (rms_mod.counter.count, fa_mod.counter.count) == \
        (before[0] + 1, before[1] + 1)
    assert _build._entries == bound
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, g), **TOL[x.dtype])
    torch.testing.assert_close(out, ref.flash_attention_ref(q, q, q),
                               **TOL[q.dtype])


def test_kernels_reject_what_they_do_not_take(gen):
    x = _rand(gen, (4, 6), torch.float32)
    with pytest.raises(ValueError, match="multiple of 4"):
        rms_mod.rmsnorm(x, x[0])
    with pytest.raises(TypeError):
        rms_mod.rmsnorm(x.double(), x[0].double())
    q = _rand(gen, (1, 8, 2, 200), torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        fa_mod.flash_attention(q, q, q)
    q = _rand(gen, (1, 8, 2, 136), torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        fa_mod.flash_attention(q, q, q)     # Dv 136
    q = _rand(gen, (1, 8, 2, 16), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa_mod.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                               q.transpose(1, 2))
    q = _rand(gen, (1, 8, 2, 12), torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa_mod.flash_attention(q, q, q)
    q = _rand(gen, (1, 8, 2, 17), torch.float32)[..., 1:]
    with pytest.raises(ValueError, match="contiguous"):
        fa_mod.flash_attention(q, q, q)
    q = _rand(gen, (1, 8 * 2 * 16 + 1), torch.float32)[:, 1:].view(
        1, 8, 2, 16)
    with pytest.raises(ValueError, match="16-byte"):
        fa_mod.flash_attention(q, q, q)


# the backward: the reference's five cases (tests/test_kernels.py:183-189),
# G 1 / 2 / 4 / 8, window 64, D 128, MLA's D 192 / Dv 128, D != Dv,
# ragged tiles, rows that see no key (Sq > Sk)
@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", [
    (2, 256, 256, 4, 4, 64, 64, True, 0),
    (2, 128, 384, 4, 2, 64, 64, True, 0),
    (2, 256, 256, 4, 1, 64, 64, False, 0),
    (2, 256, 256, 8, 2, 64, 64, True, 64),
    (2, 100, 200, 4, 2, 64, 64, True, 0),
    (1, 512, 512, 32, 8, 64, 64, True, 0),     # llama3.2-1b's heads
    (2, 96, 96, 64, 8, 128, 128, True, 0),     # G = 8, D 128
    (1, 160, 160, 16, 16, 192, 128, True, 0),  # MLA
    (2, 70, 90, 6, 3, 64, 32, True, 16),       # D != Dv, windowed, ragged
    (2, 37, 37, 6, 2, 32, 32, False, 0),       # G = 3, full
    (1, 48, 16, 4, 1, 32, 32, True, 0),        # Sq > Sk: rows see no key
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain(gen, b, sq, sk, h, kv, d, dv,
                                             causal, window, dtype):
    """Through the autograd Function: the forward writes its lse (which
    matches the plain version's), the backward kernel's dq, dk, dv match
    the plain blockwise backward (f32 5e-4, bf16 3e-2), and a row that
    sees no key gets a zero dq."""
    q, k = _rand(gen, (b, sq, h, d), dtype), _rand(gen, (b, sk, kv, d), dtype)
    v, do = _rand(gen, (b, sk, kv, dv), dtype), _rand(gen, (b, sq, h, dv),
                                                      dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa_mod.counter.count, fa_mod.bwd_counter.count)
    out = fa_mod.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa_mod.counter.count, fa_mod.bwd_counter.count) == \
        (before[0] + 1, before[1] + 1)
    exp_out, exp_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window,
                                               return_lse=True)
    torch.testing.assert_close(out.detach().float(), exp_out.float(),
                               **TOL[dtype])
    _, lse = fa_mod._launch(q, k, v, causal, window, None, want_lse=True)
    torch.testing.assert_close(lse, exp_lse, **TOL[torch.float32])
    exp = ref.flash_attention_bwd_ref(q, k, v, out.detach(), lse, do,
                                      causal=causal, window=window)
    tol = dict(atol=5e-4, rtol=5e-4) if dtype == torch.float32 \
        else TOL[dtype]
    for g, e in zip(got, exp):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), e.float(), **tol)
    blind = torch.isinf(exp_lse)
    if blind.any():
        assert got[0][blind].abs().max() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_is_deterministic(gen, dtype):
    """No atomics and a fixed order of every sum: two backward calls at
    llama3.2-1b's heads give bit-equal dq, dk and dv."""
    b, sq, sk, h, kv, d, dv, causal, window = (1, 512, 512, 32, 8, 64, 64,
                                               True, 0)
    q, k = _rand(gen, (b, sq, h, d), dtype), _rand(gen, (b, sk, kv, d), dtype)
    v, do = _rand(gen, (b, sk, kv, dv), dtype), _rand(gen, (b, sq, h, dv),
                                                      dtype)
    out, lse = fa_mod._launch(q, k, v, causal, window, None, want_lse=True)
    first = fa_mod._launch_bwd(q, k, v, out, lse, do, causal, window, None)
    second = fa_mod._launch_bwd(q, k, v, out, lse, do, causal, window, None)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_flash_backward_rejects_what_it_does_not_take(gen):
    q = _rand(gen, (1, 8, 2, 16), torch.float32)
    out, lse = fa_mod._launch(q, q, q, True, 0, None, want_lse=True)
    with pytest.raises(ValueError, match="do not match"):
        fa_mod._launch_bwd(q, q, q, out, lse[:, :4], out, True, 0, None)
    with pytest.raises(TypeError, match="f32 lse"):
        fa_mod._launch_bwd(q, q, q, out, lse.double(), out, True, 0, None)
    with pytest.raises(ValueError, match="contiguous"):
        fa_mod._launch_bwd(q, q, q, out, lse,
                           out.transpose(1, 2).contiguous().transpose(1, 2),
                           True, 0, None)


def test_a_forward_without_grad_writes_no_lse_and_saves_nothing(
        gen, monkeypatch):
    """The served path: a forward with no input that requires grad (or
    under no_grad) launches the forward kernel with a null lse pointer,
    one launch a call and no backward; the llama smoke forward launches
    a norm per block and sublayer plus the final one, and a flash a
    layer, as before."""
    seen = []
    real = _build.entry("flash_attention_fwd")

    def spy(*args):
        seen.append(args[4])
        return real(*args)

    monkeypatch.setitem(_build._entries, "flash_attention_fwd", spy)
    q = _rand(gen, (1, 8, 4, 64), torch.float32)
    out = fa_mod.flash_attention(q, q, q)
    with torch.no_grad():
        fa_mod.flash_attention(q.requires_grad_(True), q, q)
    assert out.grad_fn is None and seen == [None, None]
    cfg = get_smoke("llama3.2-1b")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 32), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    counts = (rms_mod.counter.count, fa_mod.counter.count,
              fa_mod.bwd_counter.count)
    seen.clear()
    logits, _ = model.forward(params, {"tokens": tok})
    torch.cuda.synchronize()
    assert logits.grad_fn is None and len(seen) == cfg.num_layers
    layers = cfg.num_layers
    assert (rms_mod.counter.count - counts[0], fa_mod.counter.count -
            counts[1], fa_mod.bwd_counter.count - counts[2]) == \
        (2 * layers + 1, layers, 0)
    assert set(seen) == {None}


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _chip_smoke():
    """The repo root's chip_smoke module, whose launch counts the card's
    training phases hold every step to."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _drop_free(cfg):
    """Room for every routed assignment (capacity factor E / k), so that
    no route the card's rounding flips drops a token the CPU keeps."""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)


@pytest.mark.parametrize("arch,seq", [("llama3.2-1b", 96),
                                      ("llama3.2-1b-sw", 96),
                                      # the hybrid: two scan chunks of 64
                                      ("jamba-1.5-large-398b", 128),
                                      # MoE, drop-free; MLA with MTP;
                                      # an encoder over stub frames and a
                                      # cross-attention; an image prefix
                                      ("granite-moe-1b-a400m", 96),
                                      ("deepseek-v3-671b", 96),
                                      ("whisper-small", 96),
                                      ("pixtral-12b", 96)])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_backward_reaches_every_leaf_through_the_kernels(gen, arch, seq,
                                                              remat):
    """One loss.backward() on a smoke model on the card (the llamas, the
    hybrid's expert-free smoke Jamba, granite-moe and DeepSeek
    drop-free, whisper with its stub frames, pixtral with its stub
    patches): every leaf gets a finite, nonzero gradient (the kernels
    carry gradients), the launches are the step's, counted from the
    config (chip_smoke.launches_per_train_step), and the gradients match
    the CPU's."""
    chip_smoke = _chip_smoke()
    cfg = get_smoke(arch)
    if cfg.family == "hybrid":
        cfg = without_experts(cfg)
    cfg = dataclasses.replace(_drop_free(cfg), remat=remat)
    cpu, card = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    card_params = _to(params, "cuda")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, seq),
                                     generator=g)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn(2, cfg.encoder_max_frames, 128,
                                      generator=g)
    if cfg.num_image_tokens:
        batch["image_feats"] = torch.randn(2, cfg.num_image_tokens, 1024,
                                           generator=g)
    counters = (rms_mod.counter, fa_mod.counter, fa_mod.bwd_counter,
                ms_mod.counter, ms_mod.bwd_counter)
    grads = []
    for model, p, b in ((card, card_params, _to(batch, "cuda")),
                        (cpu, params, batch)):
        flat = _flat(p)
        for leaf in flat:
            leaf.requires_grad_(True)
        counts = [c.count for c in counters]
        model.loss(p, b).backward()
        if model is card:
            torch.cuda.synchronize()
            # remat runs each layer's forward again in the backward
            want = chip_smoke.launches_per_train_step(cfg, seq)
            assert dict(zip(want, (c.count - n for c, n in
                                   zip(counters, counts)))) == want
        grads.append([leaf.grad for leaf in flat])
    for g, e in zip(*grads):
        assert g is not None and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0
        scale = float(e.abs().max())
        assert float((g.cpu() - e).abs().max()) <= 5e-4 * scale


def test_decode_and_scan_refuse_grad_on_the_card(gen):
    """Decode attention refuses grad: it has no backward (a decode step
    is not trained). The scan no longer refuses: under grad it launches
    its forward and its backward kernel and gives the plain version's
    gradient."""
    q = _rand(gen, (1, 1, 4, 64), torch.float32).requires_grad_(True)
    kc = _rand(gen, (1, 16, 4, 64), torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        da_mod.decode_attention(q, kc, kc, 8)
    with torch.no_grad():
        da_mod.decode_attention(q, kc, kc, 8)
    dt = _rand(gen, (1, 4, 64), torch.float32).requires_grad_(True)
    bc = _rand(gen, (1, 4, 16), torch.float32)
    a, h0 = -torch.ones(64, 16, device="cuda"), torch.zeros(
        1, 64, 16, device="cuda")
    counts = (ms_mod.counter.count, ms_mod.bwd_counter.count)
    y, _ = ms_mod.mamba_scan(dt, dt, bc, bc, a, h0)
    (got,) = torch.autograd.grad(y.sum(), dt)
    torch.cuda.synchronize()
    assert (ms_mod.counter.count, ms_mod.bwd_counter.count) == \
        (counts[0] + 1, counts[1] + 1)
    leaf = dt.detach().clone().requires_grad_(True)
    ye, _ = ref.mamba_scan_ref(leaf, leaf, bc, bc, a, h0)
    (exp,) = torch.autograd.grad(ye.sum(), leaf)
    torch.testing.assert_close(got, exp, atol=5e-4, rtol=5e-4)
    with torch.no_grad():
        ms_mod.mamba_scan(dt, dt, bc, bc, a, h0)
    assert ms_mod.bwd_counter.count == counts[1] + 1


@pytest.mark.parametrize("b,smax,h,kv,d,dv,vl,window", [
    (1, 512, 4, 4, 64, 64, 1, 0),
    (2, 1024, 8, 2, 64, 64, 511, 0),
    (4, 512, 4, 1, 128, 128, 512, 0),
    (2, 512, 4, 2, 64, 64, 400, 128),
    (8, 1024, 32, 8, 64, 64, 1024, 0),     # llama3.2-1b served shape
    (8, 1024, 32, 8, 64, 64, 513, 0),
    (2, 600, 8, 2, 64, 64, 577, 0),        # Smax of no block multiple
    (1, 300, 16, 1, 32, 64, 300, 64),      # G = 16, D != Dv
    (3, 64, 4, 2, 64, 64, 0, 0),           # no valid key: 0
    (8, 1024, 64, 8, 128, 128, 544, 0),    # the hybrid's decode shape
    (2, 512, 17, 1, 64, 64, 300, 0),       # G = 17: head groups 4, 4, 4, 4, 1
    (2, 512, 12, 2, 64, 64, 401, 0),       # G = 6
    (2, 1024, 48, 1, 128, 128, 777, 0),    # G = 48: granite-34b's decode
    (1, 8192, 32, 8, 64, 64, 8192, 0),     # 8192 slots: the 8-CTA cluster
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(gen, b, smax, h, kv, d, dv, vl, window,
                                     dtype):
    q = _rand(gen, (b, 1, h, d), dtype)
    k = _rand(gen, (b, smax, kv, d), dtype)
    v = _rand(gen, (b, smax, kv, dv), dtype)
    before = da_mod.counter.count
    got = da_mod.decode_attention(q, k, v, vl, window=window)
    torch.cuda.synchronize()
    assert da_mod.counter.count == before + 1
    assert got.dtype == dtype and got.shape == (b, 1, h, dv)
    exp = ref.decode_attention_ref(q, k, v, vl, window=window)
    torch.testing.assert_close(got.float(), exp.float(), **TOL[dtype])


def test_decode_kernel_reads_no_slot_past_valid_len(gen):
    q = _rand(gen, (2, 1, 8, 64), torch.float32)
    k = _rand(gen, (2, 256, 2, 64), torch.float32)
    v = _rand(gen, (2, 256, 2, 64), torch.float32)
    exp = da_mod.decode_attention(q, k, v, 100)
    k[:, 100:], v[:, 100:] = float("nan"), float("nan")
    torch.testing.assert_close(da_mod.decode_attention(q, k, v, 100), exp,
                               rtol=0, atol=0)


def test_decode_kernel_rejects_what_it_does_not_take(gen):
    q = _rand(gen, (1, 1, 4, 64), torch.float32)
    k = _rand(gen, (1, 128, 2, 64), torch.float32)
    with pytest.raises(TypeError, match="host int"):
        da_mod.decode_attention(q, k, k, torch.tensor(5, device="cuda"))
    with pytest.raises(ValueError, match="valid_len"):
        da_mod.decode_attention(q, k, k, 129)
    with pytest.raises(ValueError, match="contiguous"):
        da_mod.decode_attention(q, k[:, ::2], k[:, ::2], 5)
    with pytest.raises(TypeError):
        da_mod.decode_attention(q, k.bfloat16(), k.bfloat16(), 5)
    q136 = _rand(gen, (1, 1, 4, 136), torch.float32)
    k136 = _rand(gen, (1, 128, 2, 136), torch.float32)
    with pytest.raises(ValueError, match="up to 128"):
        da_mod.decode_attention(q136, k136, k136, 5)
    q12 = _rand(gen, (1, 1, 4, 12), torch.float32)
    k12 = _rand(gen, (1, 128, 2, 12), torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        da_mod.decode_attention(q12, k12, k12, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_call_is_one_kernel_and_one_allocation(gen, dtype):
    """One call at the served shape launches one CUDA kernel (a cluster
    of at most 8 CTAs holds the split-K combine) and allocates only its
    output."""
    from torch.profiler import ProfilerActivity, profile
    q = _rand(gen, (8, 1, 32, 64), dtype)
    k = _rand(gen, (8, 1024, 8, 64), dtype)
    v = _rand(gen, (8, 1024, 8, 64), dtype)
    da_mod.decode_attention(q, k, v, 1024)
    torch.cuda.synchronize()
    splits, _, groups = da_mod.split_plan(8, 8, 1024, _sms(), 4)
    assert 1 <= splits <= da_mod.MAX_SPLITS and groups == 1
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = da_mod.decode_attention(q, k, v, 1024)
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after - before == 1 and out.shape == (8, 1, 32, 64)
    for _ in range(3):   # the profiler has missed a first trace's kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            da_mod.decode_attention(q, k, v, 1024)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert [e.name for e in kernels if "decode_attention_kernel" in e.name] \
        and len(kernels) == 1, [e.name for e in kernels]


def test_decode_clusters_fit_the_card(gen):
    """A cluster of 8 CTAs fits at the served, the hybrid's and the
    G = 48 shapes' shared-memory sizes, in both dtypes."""
    for h, kv, d in ((32, 8, 64), (64, 8, 128), (48, 1, 128)):
        groups = -(-h // kv // da_mod.HEADS_PER_CTA)
        for dtype in (torch.float32, torch.bfloat16):
            assert da_mod.max_active_clusters(
                dtype, h, kv, d, d, da_mod.MAX_SPLITS, groups) >= 1


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _scan_inputs(gen, b, length, d, n, dtype):
    """dt, x, b, c in ``dtype``, a and h0 in f32, drawn as the reference's
    kernel sweep draws them."""
    f32 = torch.float32
    return [torch.nn.functional.softplus(_rand(gen, (b, length, d), f32)
                                         * 0.3).to(dtype),
            _rand(gen, (b, length, d), dtype),
            (_rand(gen, (b, length, n), f32) * 0.5).to(dtype),
            (_rand(gen, (b, length, n), f32) * 0.5).to(dtype),
            -torch.exp(_rand(gen, (d, n), f32) * 0.3),
            _rand(gen, (b, d, n), f32) * 0.1]


@pytest.mark.parametrize("b,length,d,n", [
    (2, 300, 192, 8),
    (2, 300, 192, 16),
    (1, 300, 192, 32),
    (3, 1, 192, 16),        # a decode step
    (2, 1, 256, 32),
    (1, 37, 64, 64),
    (8, 256, 16384, 16),    # the hybrid's prefill chunk
    (8, 1, 16384, 16),      # ... and its decode step
    (2, 300, 192, 64),
    (2, 300, 200, 16),      # D of no block multiple, 16-byte rows
    (2, 300, 190, 16),      # ... rows of no 16-byte multiple: plain loads
    (3, 1, 190, 64),
    (1, 5, 190, 8),         # fewer steps than a ring stage holds
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_matches_plain(gen, b, length, d, n, dtype):
    args = _scan_inputs(gen, b, length, d, n, dtype)
    before = ms_mod.counter.count
    y, h = ms_mod.mamba_scan(*args)
    torch.cuda.synchronize()
    assert ms_mod.counter.count == before + 1
    assert y.dtype == dtype and y.shape == (b, length, d)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)
    ye, he = ref.mamba_scan_ref(*args)
    torch.testing.assert_close(y.float(), ye.float(), **TOL[dtype])
    torch.testing.assert_close(h, he, atol=5e-5, rtol=5e-5)


def test_mamba_scan_kernel_carries_the_state(gen):
    dt, x, b, c, a, h0 = _scan_inputs(gen, 2, 300, 192, 16, torch.float32)
    y, h = ms_mod.mamba_scan(dt, x, b, c, a, h0)
    y1, h1 = ms_mod.mamba_scan(*(t[:, :100].contiguous()
                                 for t in (dt, x, b, c)), a, h0)
    y2, h2 = ms_mod.mamba_scan(*(t[:, 100:].contiguous()
                                 for t in (dt, x, b, c)), a, h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, **TOL[y.dtype])
    torch.testing.assert_close(h2, h, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_takes_rows_off_16_bytes(gen, dtype):
    """dt, x, b and c that start one element past a 16-byte boundary take
    the plain loads into the ring, and agree with the plain version."""
    args = _scan_inputs(gen, 2, 70, 256, 16, dtype)
    for i in range(4):
        buf = torch.empty(args[i].numel() + 1, dtype=dtype, device="cuda")
        args[i] = buf[1:].view(args[i].shape).copy_(args[i])
        assert args[i].is_contiguous() and args[i].data_ptr() % 16
    y, h = ms_mod.mamba_scan(*args)
    ye, he = ref.mamba_scan_ref(*args)
    torch.testing.assert_close(y.float(), ye.float(), **TOL[dtype])
    torch.testing.assert_close(h, he, atol=5e-5, rtol=5e-5)


def test_mamba_scan_launch_plan_fits_the_card(gen):
    """At the hybrid's prefill chunk the scan's grid is one wave: every
    CTA is resident at once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        grid, per_sm = ms_mod.launch_plan(dtype, 8, 256, 16384, 16)
        assert grid == 512 and per_sm >= 1
        assert grid <= per_sm * sms, (grid, per_sm, sms)
        grid, per_sm = ms_mod.launch_plan(dtype, 8, 1, 16384, 16)
        assert grid == 8 * 16384 * 4 // 256 and per_sm >= 1


def test_mamba_scan_kernel_rejects_what_it_does_not_take(gen):
    dt, x, b, c, a, h0 = _scan_inputs(gen, 1, 8, 64, 12, torch.float32)
    with pytest.raises(ValueError, match="state size N"):
        ms_mod.mamba_scan(dt, x, b, c, a, h0)
    dt, x, b, c, a, h0 = _scan_inputs(gen, 1, 8, 64, 16, torch.float32)
    bc = torch.cat([b, c], dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        ms_mod.mamba_scan(dt, x, bc[..., :16], bc[..., 16:], a, h0)
    with pytest.raises(TypeError, match="float32 state"):
        ms_mod.mamba_scan(dt, x, b, c, a, h0.bfloat16())
    with pytest.raises(TypeError):
        ms_mod.mamba_scan(dt, x.bfloat16(), b, c, a, h0)
    with pytest.raises(ValueError, match="disagree"):
        ms_mod.mamba_scan(dt, x, b, c, a[:32], h0)


# the backward: the hybrid's training chunk (B 1, L 256, D 16384, N 16),
# then L 1, L off a segment, every N, D off a CTA, batch rows, a dt A far
# below exp's range; then eight rows of the chunk, N 64 at its width, and
# D off a CTA of 64 channels (N 8, 16) and of 32 (N 64)
SCAN_BWD_CASES = [
    (1, 256, 16384, 16, 1.0),
    (3, 1, 192, 16, 1.0),
    (2, 37, 192, 16, 1.0),
    (2, 300, 192, 8, 1.0),
    (1, 70, 192, 32, 1.0),
    (2, 37, 128, 64, 1.0),
    (2, 64, 190, 16, 1.0),
    (1, 33, 200, 64, 1.0),
    (2, 50, 192, 16, 1000.0),
    (8, 256, 16384, 16, 1.0),
    (1, 64, 16384, 64, 1.0),
    (2, 40, 100, 16, 1.0),
    (2, 50, 72, 8, 1.0),
    (2, 33, 48, 64, 1.0),
]
BWD_REL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}


def _scan_bwd_inputs(gen, b, length, d, n, dtype, a_scale=1.0):
    args = _scan_inputs(gen, b, length, d, n, dtype)
    args[4] = args[4] * a_scale
    return args + [_rand(gen, (b, length, d), dtype),
                   _rand(gen, (b, d, n), torch.float32)]


def _assert_rel(got, exp, rel):
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype and g.shape == e.shape
        scale = max(float(e.float().abs().max()), 1e-30)
        err = float((g.float() - e.float()).abs().max())
        assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("b,length,d,n,a_scale", SCAN_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_backward_kernel_matches_plain(gen, b, length, d, n,
                                                  a_scale, dtype):
    """Through MambaScan: one forward and one backward launch, and ddt,
    dx, db, dc, da, dh0 within the backward's bar of the plain reverse
    recurrence (f32 5e-4, bf16 3e-2 of each output's largest entry)."""
    args = _scan_bwd_inputs(gen, b, length, d, n, dtype, a_scale)
    leaves = [t.clone().requires_grad_(True) for t in args[:6]]
    counts = (ms_mod.counter.count, ms_mod.bwd_counter.count)
    y, h = ms_mod.mamba_scan(*leaves)
    got = torch.autograd.grad((y, h), leaves, (args[6], args[7]))
    torch.cuda.synchronize()
    assert (ms_mod.counter.count, ms_mod.bwd_counter.count) == \
        (counts[0] + 1, counts[1] + 1)
    exp = ref.mamba_scan_bwd_ref(*args)
    _assert_rel(got, exp, BWD_REL[dtype])
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_backward_kernel_is_deterministic(gen, dtype):
    """No atomics and a fixed order of every sum: two backward calls at
    the training chunk give bit-equal gradients."""
    args = _scan_bwd_inputs(gen, 1, 256, 16384, 16, dtype)
    first = ms_mod._launch_bwd(*args)
    second = ms_mod._launch_bwd(*args)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_backward_takes_rows_off_16_bytes(gen, dtype):
    """dt, x, dy, b and c that start one element past a 16-byte boundary:
    the rows take 4-byte copies (a bf16 pair off 4 bytes two plain
    loads), b and c are copied aligned, and the gradients agree with the
    plain version."""
    args = _scan_bwd_inputs(gen, 2, 40, 256, 16, dtype)
    for i in (0, 1, 2, 3, 6):
        buf = torch.empty(args[i].numel() + 1, dtype=dtype, device="cuda")
        args[i] = buf[1:].view(args[i].shape).copy_(args[i])
        assert args[i].is_contiguous() and args[i].data_ptr() % 16
    got = ms_mod._launch_bwd(*args)
    _assert_rel(got, ref.mamba_scan_bwd_ref(*args), BWD_REL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_backward_launch_plan_fills_the_card(gen, dtype):
    """At the training chunk the backward's main kernel holds at least 16
    warps an SM (four lanes a channel), in one wave of 256 CTAs."""
    grid, per_sm = ms_mod.bwd_launch_plan(dtype, 1, 256, 16384, 16)
    assert grid == 16384 // 64
    assert per_sm * ms_mod.BWD_THREADS[16] // 32 >= 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert grid <= per_sm * sms


def test_mamba_scan_backward_rejects_what_it_does_not_take(gen):
    args = _scan_bwd_inputs(gen, 1, 8, 64, 16, torch.float32)
    with pytest.raises(ValueError, match="do not match"):
        ms_mod._launch_bwd(*args[:6], args[6][:, :4], args[7])
    with pytest.raises(ValueError, match="do not match"):
        ms_mod._launch_bwd(*args[:7], args[7][..., :8])
    with pytest.raises(TypeError, match="float32 state"):
        ms_mod._launch_bwd(*args[:5], args[5].bfloat16(), *args[6:])
    with pytest.raises(ValueError, match="contiguous"):
        ms_mod._launch_bwd(args[0].transpose(1, 2).contiguous().transpose(
            1, 2), *args[1:])
    odd = _scan_bwd_inputs(gen, 1, 8, 64, 12, torch.float32)
    with pytest.raises(ValueError, match="state size N"):
        ms_mod._launch_bwd(*odd)


def test_hybrid_on_the_card_matches_the_cpu(gen):
    """The expert-free Jamba smoke model: forward over two scan chunks,
    then prefill + 8 greedy steps, through the kernels against the CPU
    path with the same parameters (tolerance 1e-4)."""
    cfg = without_experts(get_smoke("jamba-1.5-large-398b"))
    cpu, card = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    card_params = _to(params, "cuda")
    tok = torch.randint(0, cfg.vocab_size, (2, 128),
                        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        before = ms_mod.counter.count
        got, _ = card.forward(card_params, {"tokens": tok.cuda()})
        assert ms_mod.counter.count - before == 7 * 2
        exp, _ = cpu.forward(params, {"tokens": tok})
        torch.testing.assert_close(got.cpu(), exp, atol=1e-4, rtol=1e-4)
        exp, state = cpu.prefill(params, {"tokens": tok}, 136)
        got, card_state = card.prefill(card_params, {"tokens": tok.cuda()},
                                       136)
        before = ms_mod.counter.count
        for i in range(8):
            torch.testing.assert_close(got.cpu(), exp, atol=1e-4, rtol=1e-4)
            nxt = exp.argmax(-1)
            exp, state = cpu.decode_step(params, nxt, 128 + i, state)
            got, card_state = card.decode_step(card_params, nxt.cuda(),
                                               128 + i, card_state)
        torch.testing.assert_close(got.cpu(), exp, atol=1e-4, rtol=1e-4)
    assert ms_mod.counter.count - before == 7 * 8
    for got_leaf, exp_leaf in zip(_leaves(_to(card_state[0], "cpu")),
                                  _leaves(state[0])):
        torch.testing.assert_close(got_leaf, exp_leaf, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,prompt,steps,smax", [
    ("llama3.2-1b", 9, 3, 16),
    ("llama3.2-1b-sw", 96, 40, 160),       # ring tail, then the ring wraps
])
def test_decode_path_on_the_card_matches_the_cpu(gen, arch, prompt, steps,
                                                 smax):
    cfg = get_smoke(arch)
    cpu, card = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    card_params = _to(params, "cuda")
    tok = torch.randint(0, cfg.vocab_size, (2, prompt),
                        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        exp, state = cpu.prefill(params, {"tokens": tok}, smax)
        got, card_state = card.prefill(card_params,
                                       {"tokens": tok.cuda()}, smax)
        before = da_mod.counter.count
        for i in range(steps):
            torch.testing.assert_close(got.cpu(), exp, atol=1e-4, rtol=1e-4)
            nxt = exp.argmax(-1)
            exp, state = cpu.decode_step(params, nxt, prompt + i, state)
            got, card_state = card.decode_step(card_params, nxt.cuda(),
                                               prompt + i, card_state)
        torch.testing.assert_close(got.cpu(), exp, atol=1e-4, rtol=1e-4)
    assert da_mod.counter.count - before == steps * cfg.num_layers


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------- the stages' CUDA graphs

STAGES = ("xlstm-125m", "llama3.2-1b")
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


@pytest.fixture(scope="module")
def smoke_stages():
    """Both cascade stages at smoke size with every bucket captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    stages = {a: make_stage(a, "cuda", full=False, seed=0) for a in STAGES}
    for st in stages.values():
        st.warmup()
    return stages


def _rows(st, n, seed):
    return np.random.default_rng(seed).integers(
        0, st.cfg.vocab_size, (n, SEQ), dtype=np.int32)


def _counts():
    return [m.counter.count for m in (rms_mod, fa_mod, da_mod, ms_mod)]


@pytest.mark.parametrize("b", BUCKETS)
@pytest.mark.parametrize("arch", STAGES)
def test_replay_equals_the_eager_forward(smoke_stages, arch, b):
    st = smoke_stages[arch]
    assert sorted(st.graphs) == list(BUCKETS)
    rows = _rows(st, b, b)
    out = np.stack(st.run_batch(list(rows)))
    with torch.inference_mode():
        exp, _ = st.model.forward(st.params, {"tokens": torch.from_numpy(
            rows).cuda()})
    assert torch.equal(st.graphs[b].logits, exp)
    np.testing.assert_array_equal(out[:, :-1], rows[:, 1:])
    np.testing.assert_array_equal(out[:, -1],
                                  exp[:, -1].argmax(-1).cpu().numpy())


@pytest.mark.parametrize("arch", STAGES)
def test_replay_adds_the_launches_its_capture_counted(smoke_stages, arch):
    st = smoke_stages[arch]
    rows = _rows(st, 8, 0)
    before = _counts()
    with torch.inference_mode():
        st.model.forward(st.params, {"tokens": torch.from_numpy(rows).cuda()})
    eager = [a - b for a, b in zip(_counts(), before)]
    assert eager[0] > 0
    for n in (8, 5):            # a full bucket, and a padded one
        before = _counts()
        st.run_batch(list(rows[:n]))
        assert [a - b for a, b in zip(_counts(), before)] == eager


@pytest.mark.parametrize("arch", STAGES)
def test_two_threads_replay_one_stage_at_once(smoke_stages, arch):
    """One slot: two threads serving one stage, on one bucket and on two,
    take turns on it and get every answer right."""
    st = smoke_stages[arch]
    jobs = [_rows(st, n, 100 + i) for i, n in enumerate((4, 4, 3, 8) * 5)]
    want = [np.stack(st.run_batch(list(r))) for r in jobs]
    got = [None] * len(jobs)

    def serve(idx):
        for i in idx:
            got[i] = np.stack(st.run_batch(list(jobs[i])))

    threads = [threading.Thread(target=serve, args=(range(k, len(jobs), 2),))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def moe_stage():
    """granite-moe at smoke size, every bucket captured: routing, its
    capacity and the dispatch run inside the graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    st = make_stage("granite-moe-1b-a400m", "cuda", full=False, seed=0)
    st.warmup()
    return st


@pytest.mark.parametrize("b", BUCKETS)
def test_moe_stage_replay_equals_the_eager_forward(moe_stage, b):
    st = moe_stage
    assert sorted(st.graphs) == list(BUCKETS)
    rows = _rows(st, b, 50 + b)
    before = _counts()
    out = np.stack(st.run_batch(list(rows)))
    replayed = [a - c for a, c in zip(_counts(), before)]
    with torch.inference_mode():
        before = _counts()
        exp, aux = st.model.forward(st.params, {"tokens": torch.from_numpy(
            rows).cuda()})
        eager = [a - c for a, c in zip(_counts(), before)]
    assert replayed == eager and eager[0] > 0 and float(aux) > 0
    torch.testing.assert_close(st.graphs[b].logits, exp, atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(out[:, :-1], rows[:, 1:])
    np.testing.assert_array_equal(out[:, -1],
                                  exp[:, -1].argmax(-1).cpu().numpy())


def test_a_failed_capture_raises(gen, monkeypatch):
    """A forward that cannot be captured fails the warm-up; the stage then
    serves nothing from that bucket, and never eagerly."""
    st = make_stage("llama3.2-1b", "cuda", full=False, seed=0)
    eager = st.model.forward

    def forward(params, batch):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("this forward cannot be captured")
        return eager(params, batch)

    monkeypatch.setattr(st.model, "forward", forward)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        st.warmup(2)
    assert st.graphs == {}
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        st.run_batch([np.zeros(SEQ, dtype=np.int32)])


# ------------------------------------------------------------ replica slots

SLOTS = 3


@pytest.fixture(scope="module")
def slotted_stages():
    """Both cascade stages at smoke size, every bucket captured in
    SLOTS replica slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    stages = {a: make_stage(a, "cuda", full=False, seed=0) for a in STAGES}
    for st in stages.values():
        st.warmup(slots=SLOTS)
    return stages


class _OnlySlot:
    """Hold every slot of a stage but ``k`` so the next batch replays on
    slot ``k``."""

    def __init__(self, st, k):
        self.cms = [st.pool.take() for _ in st.pool.slots]
        self.k = k

    def __enter__(self):
        for cm in self.cms:
            cm.__enter__()
        self.cms[self.k].__exit__(None, None, None)
        return self

    def __exit__(self, *exc):
        for i, cm in enumerate(self.cms):
            if i != self.k:
                cm.__exit__(None, None, None)


@pytest.mark.parametrize("arch", STAGES)
def test_every_slot_replays_the_eager_forward(slotted_stages, arch):
    """Each slot has its own graphs, streams and buffers, and each one's
    replay at every bucket is bit-equal to the eager forward."""
    st = slotted_stages[arch]
    slots = st.pool.slots
    assert len(slots) == SLOTS and slots[0].graphs is st.graphs
    assert len({id(s.stream) for s in slots}) == SLOTS
    for k, slot in enumerate(slots):
        assert sorted(slot.graphs) == list(BUCKETS)
        for b in BUCKETS:
            rows = _rows(st, b, 10 * k + b)
            with _OnlySlot(st, k):
                out = np.stack(st.run_batch(list(rows)))
            assert torch.equal(slot.graphs[b].tokens.cpu(),
                               torch.from_numpy(rows))
            with torch.inference_mode():
                exp, _ = st.model.forward(st.params, {
                    "tokens": torch.from_numpy(rows).cuda()})
            assert torch.equal(slot.graphs[b].logits, exp), (k, b)
            np.testing.assert_array_equal(out[:, :-1], rows[:, 1:])
            np.testing.assert_array_equal(
                out[:, -1], exp[:, -1].argmax(-1).cpu().numpy())
    other = [s.graphs[8].logits.data_ptr() for s in slots]
    assert len(set(other)) == SLOTS


@pytest.mark.parametrize("arch", STAGES)
def test_threads_on_their_own_slots_answer_as_one_thread(slotted_stages,
                                                         arch):
    """SLOTS threads serving one stage at once, over every bucket, get
    the answers one thread gets."""
    st = slotted_stages[arch]
    jobs = [_rows(st, n, 300 + i) for i, n in enumerate(BUCKETS * SLOTS)]
    want = [np.stack(st.run_batch(list(r))) for r in jobs]
    got = [None] * len(jobs)
    start = threading.Barrier(SLOTS)

    def serve(idx):
        start.wait(timeout=60)
        for i in idx:
            got[i] = np.stack(st.run_batch(list(jobs[i])))

    threads = [threading.Thread(target=serve,
                                args=(range(k, len(jobs), SLOTS),))
               for k in range(SLOTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(st.pool._free) == list(range(SLOTS))


def test_a_batch_finding_every_slot_busy_waits(slotted_stages):
    st = slotted_stages["llama3.2-1b"]
    rows = _rows(st, 4, 7)
    want = np.stack(st.run_batch(list(rows)))
    got = []
    cms = [st.pool.take() for _ in range(SLOTS)]
    for cm in cms:
        cm.__enter__()
    try:
        t = threading.Thread(
            target=lambda: got.append(np.stack(st.run_batch(list(rows)))))
        t.start()
        t.join(0.5)
        assert t.is_alive() and got == []       # every slot busy: waits
    finally:
        for cm in cms:
            cm.__exit__(None, None, None)
    t.join(60)
    assert not t.is_alive()
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("arch", STAGES)
def test_slots_replay_the_launches_of_one_forward(slotted_stages, arch):
    st = slotted_stages[arch]
    rows = _rows(st, 8, 0)
    before = _counts()
    with torch.inference_mode():
        st.model.forward(st.params, {"tokens": torch.from_numpy(rows).cuda()})
    eager = [a - b for a, b in zip(_counts(), before)]
    for k in range(SLOTS):
        launches = {c: n for c, n in st.pool.slots[k].graphs[8].launches}
        assert launches == {c: n for c, n in st.graphs[8].launches}
        with _OnlySlot(st, k):
            before = _counts()
            st.run_batch(list(rows[:5]))
            assert [a - b for a, b in zip(_counts(), before)] == eager


def test_adding_a_replica_at_runtime_captures_nothing(slotted_stages,
                                                      monkeypatch):
    """A replica the control loop adds while the cascade serves replays
    the slots captured before serving: no capture, no eager forward."""
    from repro_torch.control import ControlEvent, ScheduleController
    from repro_torch.core.pipeline import (PipelineConfig, StageConfig,
                                           linear_pipeline)
    from repro_torch.serving import LiveControlLoop, PipelineExecutor

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph was captured while serving")

    stages = [slotted_stages[a] for a in STAGES]
    n_graphs = [sum(len(s.graphs) for s in st.pool.slots) for st in stages]
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    forwards = []
    for st in stages:
        monkeypatch.setattr(st.model, "forward",
                            lambda *a, **k: forwards.append(1))
    pipe = linear_pipeline("cascade", list(STAGES),
                           {a: ["h100-1"] for a in STAGES})
    cfg = PipelineConfig({s: StageConfig("h100-1", 8, 1)
                          for s in pipe.stages})
    ex = PipelineExecutor(pipe, cfg, {a: st.run_batch
                                      for a, st in zip(STAGES, stages)})
    names = list(pipe.stages)
    sched = ScheduleController(
        [ControlEvent(0.5, 0.5, s, "up", SLOTS - 1) for s in names])
    loop = LiveControlLoop(ex, slo=1.0, epoch_s=0.5, drain_timeout_s=30.0)
    rows = _rows(stages[0], 60, 5)
    try:
        res = loop.run(np.linspace(0.0, 2.0, 60), sched, lambda i: rows[i])
    finally:
        assert ex.shutdown()
    assert res.released == 0 and np.isfinite(res.latency).all()
    assert [tl[-1][1] for tl in res.replica_timeline.values()] == \
        [SLOTS] * 2
    assert forwards == []
    assert [sum(len(s.graphs) for s in st.pool.slots)
            for st in stages] == n_graphs


# ------------------------------------------------- worker processes

PROC_ARCH = "llama3.2-1b"
PROC_READY_S = 120.0


@pytest.fixture(scope="module")
def in_process():
    """The stage a worker process must match, built here from the same
    seed, and the kernel library built before any worker starts (a
    worker loads it and never builds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    st = make_stage(PROC_ARCH, "cuda", full=False, seed=0)
    st.warmup(8)
    return st


def _need_cards(n: int) -> None:
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA GPUs, torch sees "
                    f"{torch.cuda.device_count()}")


def _spec(cards, counts_dir=None):
    return ProcessStage(PROC_ARCH, full=False, seed=0, devices=tuple(cards),
                        max_batch=8, counts_dir=counts_dir)


def _wait_for(pred, timeout_s=PROC_READY_S):
    deadline = time.perf_counter() + timeout_s
    while not pred():
        if time.perf_counter() > deadline:
            return False
        time.sleep(0.05)
    return True


@pytest.mark.parametrize("card", [0, 1])
def test_a_worker_process_answers_like_the_in_process_stage(
        in_process, tmp_path, card):
    """A spawned worker on ``cuda:<card>`` answers a fixed batch bit for
    bit as the stage in this process on cuda:0 does, and counts one
    replay's launches. On card 1 this holds the worker's current device:
    its ctypes launches go to the card its tensors are on."""
    if card:
        _need_cards(2)
    rows = list(_rows(in_process, 5, 11))
    pool = ProcessReplicaPool(_spec([f"cuda:{card}"], str(tmp_path)))
    try:
        rep = pool.spawn()
        assert rep.device == f"cuda:{card}"
        got = rep.run(rows)
        counts = worker_counts(tmp_path)[(PROC_ARCH, rep.pid)]
    finally:
        pool.close_all()
    for g, e in zip(got, in_process.run_batch(rows)):
        assert g.dtype == e.dtype and np.array_equal(g, e)
    names = dict(zip(stage_mod.COUNTERS, stage_mod.COUNT_FIELDS[1:]))
    want = dict.fromkeys(stage_mod.COUNT_FIELDS, 0)
    want["batches"] = 1
    for counter, k in in_process.graphs[8].launches:
        want[names[counter]] = k
    assert counts == want


def test_a_sigkill_mid_replay_requeues_and_the_survivor_delivers(in_process):
    """Two workers replay a burst; a crash SIGKILLs one of them while
    its ring holds batches: they are served again by the survivor, and
    every request is answered as the stage in this process answers."""
    pipe = linear_pipeline("one", [PROC_ARCH], {PROC_ARCH: ["h100-1"]})
    stage = f"s0_{PROC_ARCH}"
    cfg = PipelineConfig({stage: StageConfig("h100-1", 8, 2)})
    ex = PipelineExecutor(pipe, cfg, {PROC_ARCH: _spec(["cuda:0"])},
                          faults=FaultSchedule([crash(stage, 0.02)]),
                          backend="process")
    rows = list(_rows(in_process, 5, 12))
    exp = in_process.run_batch(rows)
    n = 1600
    try:
        assert _wait_for(lambda: ex.live_process_count(stage) == 2)
        lat = ex.serve_trace(np.zeros(n), lambda i: rows[i % 5],
                             timeout_s=PROC_READY_S)
        outs = ex.outputs()
        killed = ex.killed_worker_pids(stage)
        formed = int(ex.batch_sizes()[stage].sum())
    finally:
        assert ex.shutdown(join_timeout_s=30.0)
    assert np.isfinite(lat).all()
    assert all(np.array_equal(o, exp[i % 5]) for i, o in enumerate(outs))
    assert len(killed) == 1 and not os.path.exists(f"/proc/{killed[0]}")
    assert formed > n          # the killed worker's batches were formed again


def test_workers_go_to_the_least_loaded_card(in_process):
    """The k-th worker of a stage goes to the card holding the fewest
    live workers of that stage, lowest index first; a replacement fills
    the card a crash emptied. Every worker answers as cuda:0 does."""
    _need_cards(2)
    pipe = linear_pipeline("one", [PROC_ARCH], {PROC_ARCH: ["h100-1"]})
    stage = f"s0_{PROC_ARCH}"
    cfg = PipelineConfig({stage: StageConfig("h100-1", 1, 3)})
    ex = PipelineExecutor(pipe, cfg,
                          {PROC_ARCH: _spec(["cuda:0", "cuda:1"])},
                          backend="process")
    rows = list(_rows(in_process, 12, 13))
    try:
        assert _wait_for(lambda: ex.live_process_count(stage) == 3)
        assert sorted(ex.worker_devices(stage)) == \
            ["cuda:0", "cuda:0", "cuda:1"]
        assert ex.crash_replicas(stage, 1) == 1
        assert _wait_for(lambda: ex.live_process_count(stage) == 2)
        left = ex.worker_devices(stage)
        ex.add_replicas(stage, 1)
        assert _wait_for(lambda: ex.live_process_count(stage) == 3)
        emptied = "cuda:1" if left.count("cuda:1") == 0 else "cuda:0"
        assert sorted(ex.worker_devices(stage)) == sorted(left + [emptied])
        lat = ex.serve_trace(np.linspace(0.0, 0.2, 12), lambda i: rows[i],
                             timeout_s=PROC_READY_S)
        outs = ex.outputs()
    finally:
        assert ex.shutdown(join_timeout_s=30.0)
    assert np.isfinite(lat).all()
    # the stage here holds graphs up to 8: compare in two batches
    exp = in_process.run_batch(rows[:8]) + in_process.run_batch(rows[8:])
    for o, e in zip(outs, exp):
        assert np.array_equal(o, e)


# ------------------------------------------------------- the planner's fill

def _fill_queue(regime: str, k: int, seed: int = 7) -> np.ndarray:
    """The three load regimes of the reference's fill benchmark
    (underloaded with tie runs, calm/burst mixed, one saturating
    burst), at k queries."""
    rng = np.random.default_rng(seed)
    if regime == "underloaded":
        gaps = rng.exponential(1 / 140.0, k)
        gaps[rng.random(k) < 0.2] = 0.0
        return np.cumsum(gaps)
    if regime == "mixed":
        return np.cumsum(np.where(rng.random(k) < 0.5,
                                  rng.exponential(1 / 600.0, k),
                                  rng.exponential(1 / 60.0, k)))
    return np.zeros(k)


def _fill_lut(max_batch: int) -> np.ndarray:
    return np.array([0.0] + [0.004 + 0.0005 * b
                             for b in range(1, max_batch + 1)])


def _lanes_on(device, ready, lanes):
    """(ready_pad, luts, eff, timeouts, pools) on ``device`` for lanes
    of (eff, replicas, timeout)."""
    from repro_torch.sim.torch_backend import lane_inputs

    effs = [e for e, _, _ in lanes]
    arrays = lane_inputs([_fill_lut(e) for e in effs], effs,
                         [r for _, r, _ in lanes], [t for _, _, t in lanes])
    pad = np.concatenate([ready, np.full(max(effs), np.inf)])
    return [torch.from_numpy(a).to(device) for a in (pad, *arrays)]


FILL_LANES = [(e, r, t) for e in (1, 8, 128) for r in (1, 3, 16, 512)
              for t in (0.0, 0.005)]


@pytest.mark.parametrize("regime", ["underloaded", "mixed", "saturated"])
def test_sim_fill_grid_kernel_equals_plain_and_numpy(gen, regime):
    """24 lanes (eff 1 / 8 / 128 x replicas 1 / 3 / 16 / 512, with and
    without a timeout) over one 4096-query queue in one launch: each
    lane's completions and batches equal the plain version's on the
    card and the numpy fill's, bit for bit."""
    from repro_torch.kernels import sim_fill
    from repro_torch.sim.queueing import simulate_stage

    ready = _fill_queue(regime, 4096)
    k = ready.size
    dev = torch.device("cuda")
    pad, luts, eff, tmo, pools = _lanes_on(dev, ready, FILL_LANES)
    before = sim_fill.counter.count
    done, batches, nb = sim_fill.fill_static(pad, k, luts, eff, tmo,
                                             pools.clone(), True)
    torch.cuda.synchronize()
    assert sim_fill.counter.count == before + 1
    p_done, p_batches, p_nb = sim_fill.fill_static_ref(
        pad, k, luts, eff, tmo, pools.clone(), True)
    assert torch.equal(done, p_done) and torch.equal(nb, p_nb)
    for i, (e, r, t) in enumerate(FILL_LANES):
        n = int(nb[i])
        assert torch.equal(batches[i, :n], p_batches[i, :n])
        want_done, want_batches, _ = simulate_stage(
            "fifo", ready, _fill_lut(e), e, r, None, t)
        assert np.array_equal(done[i].cpu().numpy(), want_done), (e, r, t)
        assert np.array_equal(batches[i, :n].cpu().numpy(), want_batches)


def test_sim_fill_edge_queues_equal_numpy(gen, monkeypatch):
    """Ties, +inf arrivals and a one-query queue through the single-fill
    entry (the threshold forced to 0), against the numpy fill."""
    from repro_torch.kernels import sim_fill
    from repro_torch.sim import torch_backend as tb
    from repro_torch.sim.queueing import simulate_stage

    monkeypatch.setattr(tb, "_FILL_THRESHOLD", 0)
    ties = np.sort(np.concatenate([np.cumsum(np.full(300, 0.002)),
                                   np.full(100, 0.3)]))
    infs = np.concatenate([np.cumsum(np.full(200, 0.003)),
                           np.full(20, np.inf)])
    before = sim_fill.counter.count
    cases = 0
    for ready in (ties, infs, np.array([0.25])):
        for e, r, t in ((1, 1, 0.0), (8, 3, 0.01), (128, 2, 0.0),
                        (8, 512, 0.005)):
            got = simulate_stage("fifo", ready, _fill_lut(e), e, r, None, t,
                                 backend="torch", device="cuda")
            want = simulate_stage("fifo", ready, _fill_lut(e), e, r, None, t)
            for a, b in zip(got, want):
                assert np.array_equal(a, b), (ready.size, e, r, t)
            cases += 1
    assert sim_fill.counter.count == before + cases


@pytest.mark.parametrize("replicas,events", [
    (1, [(2.0, 2), (6.0, -1), (9.0, 1)]),       # scale up, down, up
    (0, [(1.0, 3)]),                            # empty pool until 1 s
    (2, [(3.0, -2)]),                           # scaled to zero: starves
    (4, [(0.5, -3), (0.5, 2), (12.0, -2)]),     # ties of events
])
@pytest.mark.parametrize("max_batch,timeout_s", [(8, 0.0), (128, 0.005)])
def test_sim_fill_dynamic_kernel_equals_plain_and_numpy(gen, monkeypatch,
                                                        replicas, events,
                                                        max_batch, timeout_s):
    from repro_torch.kernels import sim_fill
    from repro_torch.sim import torch_backend as tb
    from repro_torch.sim.queueing import simulate_stage

    monkeypatch.setattr(tb, "_FILL_THRESHOLD", 0)
    ready = _fill_queue("mixed", 4096, seed=3)
    lut = _fill_lut(max_batch)
    before = sim_fill.counter.count
    got = simulate_stage("fifo", ready, lut, max_batch, replicas, events,
                         timeout_s, backend="torch", device="cuda")
    assert sim_fill.counter.count == before + 1
    want = simulate_stage("fifo", ready, lut, max_batch, replicas, events,
                          timeout_s)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    # the same inputs through the kernel and the plain version on the
    # card (each run gets its own copy: the pool is scratch)
    args = tb.dynamic_inputs(ready, lut, max_batch, replicas, events,
                             timeout_s, torch.device("cuda"))
    copy = [x.clone() if torch.is_tensor(x) else x for x in args]
    k_done, k_b, k_n = sim_fill.fill_dynamic(*args)
    p_done, p_b, p_n = sim_fill.fill_dynamic_ref(*copy)
    assert torch.equal(k_done, p_done) and torch.equal(k_n, p_n)
    assert torch.equal(k_b[:int(k_n)], p_b[:int(p_n)])


# ------------------------------------------- the planner sweep's grid path

# the fill's four layouts: pools of up to 32 replicas live in registers,
# larger ones in shared memory (32 and 33 sit on either side); where
# every eff is at most 32 the queue lives in register windows, else
# each step loads its window (32 and 128)
REG_LANES = [(e, r, t) for e in (1, 8, 128) for r in (1, 3, 16, 32)
             for t in (0.0, 0.005)]
SMEM_LANES = [(1, 33, 0.0), (8, 33, 0.005), (128, 2, 0.0), (8, 512, 0.0)]
WIN_LANES = [(e, r, t) for e in (1, 2, 8, 32) for r in (1, 3, 16, 32)
             for t in (0.0, 0.005)]
WIN_SMEM_LANES = [(1, 33, 0.0), (8, 33, 0.005), (32, 2, 0.0), (2, 512, 0.01)]
LAYOUTS = [REG_LANES, SMEM_LANES, WIN_LANES, WIN_SMEM_LANES]
LAYOUT_IDS = ["registers", "shared", "registers-windows", "shared-windows"]


def _latency_inputs(ready, seed=5):
    """base_last and arrivals (in sorted-queue order) for a queue: the
    arrivals precede each ready time, base_last is at least the
    arrival."""
    rng = np.random.default_rng(seed)
    arrivals = np.maximum(ready - rng.gamma(2.0, 0.004, ready.size), 0.0)
    base_last = arrivals + rng.gamma(2.0, 0.01, ready.size)
    return (torch.from_numpy(base_last).cuda(),
            torch.from_numpy(arrivals).cuda())


@pytest.mark.parametrize("regime", ["underloaded", "mixed", "saturated"])
@pytest.mark.parametrize("lanes", LAYOUTS, ids=LAYOUT_IDS)
def test_sim_fill_pools_in_registers_and_shared_equal_plain(gen, regime,
                                                            lanes):
    """Completions, batches and final pools of the four layouts equal the
    plain version's on the card, and the completions the numpy fill's."""
    from repro_torch.kernels import sim_fill
    from repro_torch.sim.queueing import simulate_stage

    ready = _fill_queue(regime, 4096)
    k = ready.size
    pad, luts, eff, tmo, pools = _lanes_on(torch.device("cuda"), ready,
                                           lanes)
    k_pools, p_pools = pools.clone(), pools.clone()
    done, batches, nb = sim_fill.fill_static(pad, k, luts, eff, tmo,
                                             k_pools, True)
    p_done, p_batches, p_nb = sim_fill.fill_static_ref(
        pad, k, luts, eff, tmo, p_pools, True)
    assert torch.equal(done, p_done) and torch.equal(nb, p_nb)
    assert torch.equal(k_pools, p_pools)
    for i, (e, r, t) in enumerate(lanes):
        n = int(nb[i])
        assert torch.equal(batches[i, :n], p_batches[i, :n])
        want_done, _, _ = simulate_stage("fifo", ready, _fill_lut(e), e, r,
                                         None, t)
        assert np.array_equal(done[i].cpu().numpy(), want_done), (e, r, t)


@pytest.mark.parametrize("regime", ["underloaded", "mixed", "saturated"])
@pytest.mark.parametrize("lanes", LAYOUTS, ids=LAYOUT_IDS)
def test_sim_fill_latency_rows_equal_plain(gen, regime, lanes):
    """The grid launch's latency rows equal the plain assembly over the
    plain fill, bit for bit."""
    from repro_torch.kernels import sim_fill

    ready = _fill_queue(regime, 4096)
    k = ready.size
    pad, luts, eff, tmo, pools = _lanes_on(torch.device("cuda"), ready,
                                           lanes)
    bl, arr = _latency_inputs(ready)
    before = sim_fill.counter.count
    lat = sim_fill.fill_latency(pad, k, luts, eff, tmo, pools.clone(), bl,
                                arr, 0.0015)
    torch.cuda.synchronize()
    assert sim_fill.counter.count == before + 1
    want = sim_fill.fill_latency_ref(pad, k, luts, eff, tmo, pools.clone(),
                                     bl, arr, 0.0015)
    assert torch.equal(lat, want)


def _select_rows():
    """9a's rows: ties, +inf and FAR_FUTURE tails, n = 1, k < n (the
    segment), all equal."""
    rng = np.random.default_rng(11)
    lat = rng.gamma(2.0, 0.05, 5000)
    empty = np.empty(0)
    return {
        "ties": (np.repeat(rng.uniform(0.01, 0.2, 40), 125), empty),
        "inf tail": (np.concatenate([lat, np.full(60, np.inf)]), empty),
        "FAR_FUTURE tail": (np.concatenate([lat, np.full(90, 1e18)]), empty),
        "n = 1": (np.array([0.75]), empty),
        "k < n": (lat[:3000], lat[3000:] + 0.5),
        "all equal": (np.full(4000, 0.125), empty),
    }


def _partition_pair(row, seg, r0, r1):
    lat = np.concatenate([row, seg])
    part = np.partition(lat, (r0, r1) if r1 > r0 else (r0,))
    return float(part[r0]), float(part[r1])


@pytest.mark.parametrize("name", list(_select_rows()))
@pytest.mark.parametrize("p", [0.0, 50.0, 99.0, 100.0])
def test_sim_select_equals_plain_and_partition(gen, name, p):
    from repro_torch.kernels import sim_select
    from repro_torch.sim.torch_backend import _quantile_params

    row, seg = _select_rows()[name]
    rows = np.stack([row, row[::-1].copy(), np.sort(row)])
    prev, nxt, _ = _quantile_params(row.size + seg.size, p)
    rows_d = torch.from_numpy(rows).cuda()
    seg_d = torch.from_numpy(seg).cuda()
    before = sim_select.counter.count
    got = sim_select.select(rows_d, seg_d, prev, nxt)
    torch.cuda.synchronize()
    assert sim_select.counter.count == before + 1
    assert torch.equal(got, sim_select.select_ref(rows_d, seg_d, prev, nxt))
    for i in range(rows.shape[0]):
        assert tuple(got[i].tolist()) == _partition_pair(rows[i], seg, prev,
                                                         nxt)


def test_sim_select_at_the_sweeps_shape(gen):
    """1200 rows of 107,487 latencies (spread, tied, with +inf and
    FAR_FUTURE tails): the kernel equals its plain version and
    np.partition at p99 and p50, row by row."""
    from repro_torch.kernels import sim_select
    from repro_torch.sim.torch_backend import _quantile_params

    rng = np.random.default_rng(26)
    c, n = 1200, 107487
    rows = rng.gamma(2.0, 0.05, (c, n))
    rows[::3] = np.round(rows[::3], 2)                 # heavy ties
    rows[1::7, -2000:] = np.inf
    rows[2::7, -1500:] = 1e18
    rows_d = torch.from_numpy(rows).cuda()
    seg_d = torch.empty(0, dtype=torch.float64, device="cuda")
    for p in (99.0, 50.0):
        prev, nxt, _ = _quantile_params(n, p)
        got = sim_select.select(rows_d, seg_d, prev, nxt)
        assert torch.equal(got, sim_select.select_ref(rows_d, seg_d, prev,
                                                      nxt))
        part = np.partition(rows, (prev, nxt), axis=1)
        assert np.array_equal(got.cpu().numpy(), part[:, [prev, nxt]])


def _select_case(name):
    """Rows that take each branch of the select's two paths: the cluster's
    capacity -1, at it and +1 (the stream path), odd k (every second row
    starts 8-byte aligned), one lane, NaN."""
    from repro_torch.kernels import sim_select

    rng = np.random.default_rng(33)
    empty = np.empty(0)
    if name.startswith("capacity"):
        m = 5001
        k = sim_select.CLUSTER_CAP + int(name[len("capacity"):]) - m
        rows = rng.gamma(2.0, 0.05, (3, k))
        rows[1, -3000:] = 1e18
        rows[2] = np.round(rows[2], 3)
        return rows, rng.gamma(2.0, 0.05, m) + 0.2
    if name == "odd k":
        return rng.gamma(2.0, 0.05, (7, 107487)), rng.gamma(2.0, 0.05, 11)
    if name == "lanes 1":
        return rng.gamma(2.0, 0.05, (1, 20001)), empty
    rows = rng.gamma(2.0, 0.05, (4, 3001))
    rows[0, ::97] = np.nan
    rows[1, -40:] = np.nan
    rows[3, :] = np.nan
    return rows, empty


@pytest.mark.parametrize("name", ["capacity-1", "capacity+0", "capacity+1",
                                  "odd k", "lanes 1", "nan"])
@pytest.mark.parametrize("p", [0.0, 50.0, 99.0, 100.0])
def test_sim_select_paths_equal_plain_and_partition(gen, name, p):
    """Each row equals the plain version and np.partition (NaN last), in
    one launch down the path that k + m picks, and a second call is bit
    equal."""
    from repro_torch.kernels import sim_select
    from repro_torch.sim.torch_backend import _quantile_params

    rows, seg = _select_case(name)
    n = rows.shape[1] + seg.size
    prev, nxt, _ = _quantile_params(n, p)
    rows_d = torch.from_numpy(rows).cuda()
    seg_d = torch.from_numpy(seg).cuda()
    path = sim_select.path(n)
    assert path == ("stream" if name == "capacity+1" else "cluster")
    assert sim_select.plan(rows.shape[1], seg.size, rows.shape[0])["path"] \
        == path
    before = sim_select.counter.count
    by_path = sim_select.path_counters[path].count
    got = sim_select.select(rows_d, seg_d, prev, nxt)
    torch.cuda.synchronize()
    assert sim_select.counter.count == before + 1
    assert sim_select.path_counters[path].count == by_path + 1
    again = sim_select.select(rows_d, seg_d, prev, nxt)
    assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    plain = sim_select.select_ref(rows_d, seg_d, prev, nxt)
    assert torch.equal(got.isnan(), plain.isnan())
    assert torch.equal(got.nan_to_num(), plain.nan_to_num())
    full = np.concatenate([rows, np.broadcast_to(seg, (rows.shape[0],
                                                      seg.size))], 1)
    part = np.partition(full, (prev, nxt) if nxt > prev else (prev,),
                        axis=1)[:, [prev, nxt]]
    assert np.array_equal(got.cpu().numpy(), part, equal_nan=True)


def test_sim_select_cluster_fits_the_card(gen):
    """At the sweep's shape the select takes clusters of 16 CTAs that the
    card can hold at once (the non-portable size is allowed)."""
    from repro_torch.kernels import sim_select

    got = sim_select.plan(107487, 0, 1200)
    assert got["path"] == "cluster" and got["cluster"] == sim_select.CLUSTER
    assert got["resident"] >= 1
    big = sim_select.plan(sim_select.CLUSTER_CAP, 0, 1200)
    assert big["path"] == "cluster" and big["resident"] >= 1
    assert sim_select.plan(sim_select.CLUSTER_CAP + 1, 0, 1200)["path"] == \
        "stream"


def test_sim_grid_makes_two_launches_a_chunk(gen, monkeypatch):
    """A grid cut into three chunks launches the fill and the select
    three times each, and scores what the plain versions score on the
    CPU."""
    from repro_torch.kernels import sim_fill, sim_select
    from repro_torch.sim import torch_backend as tb

    ready = _fill_queue("mixed", 4096)
    rng = np.random.default_rng(2)
    n = 5000
    arrivals = np.sort(rng.uniform(0.0, ready[-1], n))
    order = np.sort(rng.choice(n, ready.size, replace=False))
    base_last = arrivals + rng.gamma(2.0, 0.01, n)
    lanes = WIN_LANES[:9]
    args = (ready, order, base_last, arrivals, 0.001,
            [_fill_lut(e) for e, _, _ in lanes], [e for e, _, _ in lanes],
            [r for _, r, _ in lanes], [t for _, _, t in lanes], 99.0)
    want = tb.grid_stage_percentiles(*args, torch.device("cpu"))
    monkeypatch.setattr(tb, "_GRID_OUT_BYTES", 3 * 8 * ready.size)
    fills, selects = sim_fill.counter.count, sim_select.counter.count
    split = {}
    got = tb.grid_stage_percentiles(*args, torch.device("cuda"), split=split)
    assert np.array_equal(got, want)
    assert split == {"chunks": 3, "launches": 6, "lanes": 9,
                     "queries": ready.size}
    assert sim_fill.counter.count == fills + 3
    assert sim_select.counter.count == selects + 3


def test_sim_kernels_reject_what_they_do_not_take(gen):
    from repro_torch.kernels import sim_fill, sim_select

    rows = torch.rand(3, 100, dtype=torch.float64, device="cuda")
    seg = torch.rand(5, dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="rows"):
        sim_select.select(rows.float(), seg, 0, 1)
    with pytest.raises(ValueError, match="rows"):
        sim_select.select(rows[:, ::2], seg, 0, 1)
    with pytest.raises(ValueError, match="seg"):
        sim_select.select(rows, seg.cpu(), 0, 1)
    with pytest.raises(ValueError, match="seg"):
        sim_select.select(rows, seg[None], 0, 1)
    with pytest.raises(ValueError, match="r0"):
        sim_select.select(rows, seg, 3, 105)
    with pytest.raises(ValueError, match="r0"):
        sim_select.select(rows, seg, 2, 1)
    ready = _fill_queue("mixed", 256)
    pad, luts, eff, tmo, pools = _lanes_on(torch.device("cuda"), ready,
                                           REG_LANES[:2])
    bl, arr = _latency_inputs(ready)
    with pytest.raises(ValueError, match="base_last"):
        sim_fill.fill_latency(pad, 256, luts, eff, tmo, pools, bl[1:], arr,
                              0.0)
    with pytest.raises(ValueError, match="arrivals"):
        sim_fill.fill_latency(pad, 256, luts, eff, tmo, pools, bl,
                              arr.float(), 0.0)
    with pytest.raises(ValueError, match="base_last"):
        sim_fill.fill_latency(pad, 256, luts, eff, tmo, pools, bl.cpu(), arr,
                              0.0)
    with pytest.raises(ValueError, match="rpc"):
        sim_fill.fill_latency(pad, 256, luts, eff, tmo, pools, bl, arr, -1.0)


# ---------------------------------------------------------------------------
# sharded serving and training over NCCL, four cards
# ---------------------------------------------------------------------------

SHARD_ARCHS = ("llama3.2-1b", "qwen2-72b", "granite-34b",
               "granite-moe-1b-a400m", "deepseek-v3-671b",
               "jamba-1.5-large-398b", "xlstm-125m", "whisper-small",
               "pixtral-12b")
SHARD_MESHES = ((1, 4), (2, 2))
SHARD_RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_torch_parallel_ranks.py")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_numpy_tree(v) for v in tree)
    return tree.detach().cpu().numpy()


@pytest.fixture(scope="module")
def four_card_runs(tmp_path_factory):
    """Each mesh's four NCCL ranks (one a card) on the smoke configs,
    and the plain model's outputs on cuda:0 from the same weights (with
    16 stub frames or the image features a row, as the config takes)."""
    import pickle
    import subprocess
    import sys

    from repro_torch.convert import params_from_numpy
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.train.tree import leaves

    _need_cards(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    workdir = tmp_path_factory.mktemp("sharded")
    cases, wants = {}, {}
    for arch in SHARD_ARCHS:
        cfg = get_smoke(arch)
        full = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(3)

        def feats():
            if cfg.is_encoder_decoder:
                return {"frames": rng.standard_normal((4, 16, 128),
                                                      dtype=np.float32)}
            if cfg.num_image_tokens:
                return {"image_feats": rng.standard_normal(
                    (4, cfg.num_image_tokens, 1024), dtype=np.float32)}
            return {}
        case = dict(cfg=cfg, params=_numpy_tree(full),
                    tokens=rng.integers(0, cfg.vocab_size, (4, 16)),
                    prompt=rng.integers(0, cfg.vocab_size, (4, 8)),
                    smax=32, steps=6, feats=feats(), prompt_feats=feats())
        model = build_model(cfg, "cuda")
        params = params_from_numpy(case["params"], "cuda")

        def batch(name, extra):
            return {"tokens": torch.from_numpy(case[name]).cuda(),
                    **{k: torch.from_numpy(v).cuda()
                       for k, v in case[extra].items()}}
        with torch.no_grad():
            logits, _ = model.forward(params, batch("tokens", "feats"))
            out, state = model.prefill(
                params, batch("prompt", "prompt_feats"), 32)
            steps, toks = [out], [out.argmax(-1)]
            for i in range(6):          # positions count an image prefix
                out, state = model.decode_step(
                    params, toks[-1], 8 + cfg.num_image_tokens + i, state)
                steps.append(out)
                toks.append(out.argmax(-1))
        seen = []

        class Recording(AdamW):
            def update(self, params, state, grads, sq_norm=None):
                seen.append(grads)
                return super().update(params, state, grads)

        opt = Recording(lr=1e-3)
        _, _, metrics = make_train_step(model, opt)(
            params, opt.init(params), batch("tokens", "feats"))
        cases[arch] = case
        wants[arch] = dict(
            logits=logits.cpu().numpy(),
            step_logits=torch.cat(steps, 1).cpu().numpy(),
            tokens=torch.cat(toks, 1).cpu().numpy(),
            loss=float(metrics["loss"]),
            grads=[g.cpu().numpy() for g in leaves(seen[0])])
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    runs = {}
    for data, model_size in SHARD_MESHES:
        procs = [subprocess.Popen(
            [sys.executable, SHARD_RANKS, str(r), str(data), str(model_size),
             str(workdir), "cuda"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(data * model_size)]
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            logs.append(out.decode(errors="replace"))
        path = workdir / f"out_{data}x{model_size}.pkl"
        runs[(data, model_size)] = pickle.loads(path.read_bytes()) \
            if path.exists() else {"error": "\n".join(logs)[-6000:]}
    return runs, wants


@pytest.mark.parametrize("arch", SHARD_ARCHS)
@pytest.mark.parametrize("mesh", SHARD_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_model_on_four_cards_matches_one_card(four_card_runs, mesh,
                                                      arch):
    """The sharded forward, prefill, greedy decode and train step over
    NCCL, one rank a card, against the plain model on cuda:0 from the
    same weights, through the kernels on both sides: logits 1e-4, tokens
    equal, loss and every gradient 5e-4."""
    runs, wants = four_card_runs
    res = runs[mesh]
    assert "error" not in res, res["error"]
    got, want = res[arch], wants[arch]
    assert "error" not in got, got["error"]
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["logits"], want["logits"], **tol)
    np.testing.assert_allclose(got["step_logits"], want["step_logits"],
                               **tol)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["loss"], want["loss"], atol=5e-4,
                               rtol=5e-4)
    for g, w in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4)
