"""The selective scan's backward and the hybrid's gradients on the CPU,
against the JAX reference.

- ``ref.mamba_scan_bwd_ref`` (the reverse recurrence, the CPU path's
  backward and the card check's yardstick) against ``jax.vjp`` of the
  reference's oracle ``ref.mamba_scan_ref`` and against
  ``torch.autograd`` of the port's own plain forward, with random
  cotangents for y and h_last;
- ``mamba_scan`` under grad (``MambaScan``) on the CPU: its gradients
  are the plain backward's, and two chained calls give one call's;
- the backward kernel's arithmetic and reductions
  (``csrc/mamba_scan_bwd.cu``) emulated in numpy: its ex2.approx
  exponentials, its checkpointed segments of 16 steps, the four states a
  lane in its lane's order, the shuffle trees over a channel's lanes and
  the butterfly that sums dB and dC over a warp's channels, the warps in
  order and the reduce over the CTAs;
- the Mamba block's gradients against ``jax.grad`` of the reference's
  ``mamba_block`` over two chunks, and the Jamba smoke model's against
  ``jax.grad`` of the reference's model with either of its two scans.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances, relative to each output's largest entry: f32 1e-5 (the two
sides sum in other orders); bf16 3e-2, the repo's bf16 kernel bar (the
gradients are rounded to bf16 once, after f32 sums in other orders); the
emulated kernel arithmetic 5e-4 f32 and 3e-2 bf16, the card's bars for
the backward kernel against its plain version; the block 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import mamba_scan as ms_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.train.trainer import value_and_grad  # noqa: E402

JAMBA = "jamba-1.5-large-398b"
REL = {"float32": 1e-5, "bfloat16": 3e-2}
KERNEL_REL = {"float32": 5e-4, "bfloat16": 3e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAMES = ("ddt", "dx", "db", "dc", "da", "dh0")

jax_scan_ref = jax.jit(jax_ref.mamba_scan_ref)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, b, s, d, n, a_scale=1.0):
    """dt, x, b, c, a, h0 and the cotangents dy, dh as numpy f32, the
    first six drawn as the reference's kernel sweep draws them; A times
    ``a_scale`` (a large one drives dt A far below exp's range)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)) * 0.3))
    return [v.astype(np.float32) for v in (
        dt, rng.standard_normal((b, s, d)),
        rng.standard_normal((b, s, n)) * 0.5,
        rng.standard_normal((b, s, n)) * 0.5,
        -np.exp(rng.standard_normal((d, n)) * 0.3) * a_scale,
        rng.standard_normal((b, d, n)) * 0.1,
        rng.standard_normal((b, s, d)),
        rng.standard_normal((b, d, n)))]


def _torch_args(arrays, dtype):
    """dt, x, b, c, dy in ``dtype``; a, h0, dh in f32."""
    t = [torch.from_numpy(v) for v in arrays]
    for i in (0, 1, 2, 3, 6):
        t[i] = t[i].to(TORCH_DTYPE[dtype])
    return t


def _assert_rel(got, exp, rel, what=""):
    for name, g, e in zip(NAMES, got, exp):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else \
            np.asarray(g, np.float32)
        e = e.float().numpy() if isinstance(e, torch.Tensor) else \
            np.asarray(e, np.float32)
        assert g.shape == e.shape, (what, name, g.shape, e.shape)
        scale = max(float(np.abs(e).max()), 1e-30)
        err = float(np.abs(g - e).max())
        assert err <= rel * scale, (what, name, err, scale)


# ------------------------------------------------------- the plain backward

@pytest.mark.parametrize("b,s,d,n,a_scale", [
    (2, 37, 24, 16, 1.0),
    (2, 37, 24, 8, 1.0),
    (1, 37, 20, 64, 1.0),
    (3, 1, 24, 16, 1.0),         # L 1: a decode step's shape
    (2, 1, 16, 64, 1.0),
    (2, 37, 24, 16, 1000.0),     # dt A far below exp's range: a_t is 0
], ids=["N16", "N8", "N64", "L1", "L1-N64", "very-negative-dtA"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp_of_the_oracle(b, s, d, n, a_scale,
                                                      dtype):
    arrays = _inputs(31, b, s, d, n, a_scale)
    args = _torch_args(arrays, dtype)
    jdtype = jnp.dtype(dtype)
    jargs = [jnp.asarray(v).astype(jdtype) if i in (0, 1, 2, 3, 6)
             else jnp.asarray(v) for i, v in enumerate(arrays)]
    _, vjp = jax.vjp(jax_scan_ref, *jargs[:6])
    exp = vjp((jargs[6], jargs[7]))
    got = ref.mamba_scan_bwd_ref(*args)
    for g, t in zip(got, args[:6]):
        assert g.dtype == t.dtype and g.shape == t.shape
    if a_scale > 1:
        # exp underflows at every step: h_{t-1} never reaches dh0 or dA,
        # so the recurrence has nothing to divide by zero
        assert float(torch.exp(args[0].float()[..., None]
                               * args[4]).max()) == 0.0
        assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _assert_rel(got, exp, REL[dtype])


@pytest.mark.parametrize("n", [8, 16, 64])
def test_plain_backward_matches_autograd_of_the_plain_forward(n):
    arrays = _inputs(32, 2, 29, 24, n)
    args = _torch_args(arrays, "float32")
    leaves = [t.clone().requires_grad_(True) for t in args[:6]]
    y, h = ref.mamba_scan_ref(*leaves)
    exp = torch.autograd.grad((y, h), leaves, (args[6], args[7]))
    _assert_rel(ref.mamba_scan_bwd_ref(*args), exp, REL["float32"])


def test_scan_under_grad_takes_the_plain_backward_on_the_cpu():
    """mamba_scan with an input that requires grad is MambaScan: the
    plain forward, and a backward that is the plain reverse recurrence
    (no launch is counted)."""
    args = _torch_args(_inputs(33, 2, 21, 16, 16), "float32")
    leaves = [t.clone().requires_grad_(True) for t in args[:6]]
    counts = (ms_mod.counter.count, ms_mod.bwd_counter.count)
    y, h = ms_mod.mamba_scan(*leaves)
    assert y.grad_fn is not None and "MambaScan" in type(y.grad_fn).__name__
    ye, he = ref.mamba_scan_ref(*args[:6])
    assert torch.equal(y.detach(), ye) and torch.equal(h.detach(), he)
    got = torch.autograd.grad((y, h), leaves, (args[6], args[7]))
    for g, e in zip(got, ref.mamba_scan_bwd_ref(*args)):
        assert torch.equal(g, e)
    assert (ms_mod.counter.count, ms_mod.bwd_counter.count) == counts
    # only y used: h_last's gradient is taken as zeros
    y, _ = ms_mod.mamba_scan(*leaves)
    got = torch.autograd.grad(y, leaves, args[6])
    exp = ref.mamba_scan_bwd_ref(*args[:7], torch.zeros_like(args[7]))
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


def test_two_chained_calls_give_one_calls_gradients():
    """The state's gradient flows from the second chunk's h0 into the
    first chunk: two calls chained through h, as ops.mamba_chunk is
    called a chunk at a time, give the gradients of one call."""
    arrays = _inputs(34, 2, 40, 24, 16)
    args = _torch_args(arrays, "float32")
    leaves = [t.clone().requires_grad_(True) for t in args[:6]]
    y, h = ms_mod.mamba_scan(*leaves)
    one = torch.autograd.grad((y, h), leaves, (args[6], args[7]))
    dt, x, b, c, a, h0 = leaves
    y1, h1 = ops.mamba_chunk(dt[:, :25], x[:, :25], b[:, :25], c[:, :25],
                             a, h0)
    y2, h2 = ops.mamba_chunk(dt[:, 25:], x[:, 25:], b[:, 25:], c[:, 25:],
                             a, h1)
    two = torch.autograd.grad((torch.cat([y1, y2], dim=1), h2), leaves,
                              (args[6], args[7]))
    _assert_rel(two, one, REL["float32"])
    assert float(two[5].abs().max()) > 0          # dh0 reached h0


# ------------------------------------------ the backward kernel, emulated

# ex2.approx.ftz.f32 is within 2 ulp (the bound CUDA states for exp2f,
# the same MUFU.EX2 instruction); the emulation perturbs every a_t by up
# to twice that, as tests/test_torch_mamba.py does for the forward
EX2_REL_ERR = 2.0 ** -21
LANES = 32
SEG = 16             # steps of a segment
SUM_THREADS = 512    # threads of the dB/dC reduce, a row a CTA


def _bwd_shape(n):
    """(lanes a channel G, channels a warp W, channels a CTA, warps a
    CTA) of the kernel's BwdShape: four states a lane, 16 N threads a CTA
    up to 512."""
    g = n // 4
    threads = 16 * n if n <= 16 else 512
    return g, LANES // g, threads // g, threads // LANES


def _lane_order(n):
    """The state each lane's position i holds, (32, 4): 4j + (i ^ m),
    with j the lane's place in its channel's group and m from the lane
    bits of the butterfly's state stages (offsets 16 and 8)."""
    g, w = n // 4, LANES // (n // 4)
    lanes = np.arange(LANES)
    m = np.zeros(LANES, np.int64)
    if w >= 2:
        m |= ((lanes >> 4) & 1) << 1
    if w >= 4:
        m |= (lanes >> 3) & 1
    return 4 * (lanes % g)[:, None] + (np.arange(4)[None, :] ^ m[:, None])


def _butterfly(vals, n):
    """The kernel's butterfly and write-out of one step over (..., 32
    lanes, 8 positions), position 2i + k holding dB (k 0) or dC (k 1) of
    the lane's state ``_lane_order(n)[lane, i]``: the stages at lane
    offsets 16 and 8 add the partner's upper half to the lower half (the
    states' order makes the halves match), the stage at 4 keeps dB on the
    lower lanes and dC on the upper, the stage at 2 (N 8) adds. Returns
    the (..., 2N) partial the warp leaves in shared memory, dB then dC."""
    g, w = n // 4, LANES // (n // 4)
    fly = int(np.log2(w))
    v = vals.astype(np.float32).copy()
    lanes = np.arange(LANES)
    if fly >= 1:
        v[..., :4] = v[..., :4] + v[..., lanes ^ 16, 4:8]
    if fly >= 2:
        v[..., :2] = v[..., :2] + v[..., lanes ^ 8, 2:4]
    if fly >= 3:
        up = (lanes & 4) != 0
        keep = np.where(up, v[..., 1], v[..., 0])
        send = np.where(up, v[..., 0], v[..., 1])
        v[..., 0] = keep + send[..., lanes ^ 4]
    if fly >= 4:
        v[..., 0] = v[..., 0] + v[..., lanes ^ 2, 0]
    order = _lane_order(n)
    out = np.zeros(vals.shape[:-2] + (2 * n,), np.float32)
    for lane in range(LANES):
        ob = order[lane, 0]
        if fly >= 3:
            if fly == 3 or not lane & 2:
                out[..., ((lane >> 2) & 1) * n + ob] = v[..., lane, 0]
        else:
            for e in range(8 >> min(fly, 2)):
                out[..., (e & 1) * n + (ob ^ (e >> 1))] = v[..., lane, e]
    return out


def _tree(v, axis):
    """Sum over ``axis`` (a power of two long) as the shuffle stages
    take it: the upper half onto the lower, then again."""
    v = np.moveaxis(v, axis, 0)
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        v = v[:h] + v[h:]
    return v[0]


def _bwd_kernel_arithmetic(dt, x, b, c, a, h0, dy, dh, seed):
    """``csrc/mamba_scan_bwd.cu`` in f32 numpy. Channels padded to CTAs
    (64, 32 at N 64) and steps to segments of 16, the pads zero; a_t =
    exp2(dt A log2 e) each off by up to 2 EX2_REL_ERR (the same value in
    pass 1 and in the replay, as the same instruction gives); pass 1 keeps
    the state entering each segment, pass 2 replays each from it and
    walks it back. A lane holds four states of a channel in its order:
    ddt and dx sum them in that order, then over the channel's lanes by
    the shuffle tree; dB and dC go through the butterfly, over the warps
    in order, then the reduce's strided runs over the CTAs and its tree;
    dA sums over t in the lane and over the batch in order."""
    rng = np.random.default_rng(seed)
    f = [t.float().numpy().astype(np.float32) for t in
         (dt, x, b, c, a, h0, dy, dh)]
    dtf, xf, bf, cf, af, h0f, dyf, dhf = f
    bsz, length, d = dtf.shape
    n = af.shape[1]
    g, w, cpc, warps = _bwd_shape(n)
    ctas = -(-d // cpc)
    dp = ctas * cpc
    segs = -(-length // SEG)
    lp = segs * SEG

    def pad(t, axis, size):
        shape = list(t.shape)
        shape[axis] = size - t.shape[axis]
        return np.concatenate([t, np.zeros(shape, np.float32)], axis=axis)

    dtf, xf, dyf = (pad(pad(t, 2, dp), 1, lp) for t in (dtf, xf, dyf))
    bf, cf = pad(bf, 1, lp), pad(cf, 1, lp)
    af, h0f, dhf = pad(af, 0, dp), pad(h0f, 1, dp), pad(dhf, 1, dp)
    a2 = (af * np.float32(1.4426950408889634)).astype(np.float32)
    a_bar = np.exp2(dtf[..., None] * a2).astype(np.float32)
    a_bar *= 1 + (rng.random(a_bar.shape, dtype=np.float32) * 2 - 1) \
        * np.float32(EX2_REL_ERR)
    a_bar[:, length:] = 1        # the padded steps take no exponential
    bx = dtf * xf

    def step(h, t):
        return a_bar[:, t] * h + bx[:, t, :, None] * bf[:, t, None, :]

    # pass 1: the state entering each segment
    ckpt, h = [h0f], h0f
    for t in range((segs - 1) * SEG):
        h = step(h, t)
        if (t + 1) % SEG == 0:
            ckpt.append(h)
    # each channel's lanes: lane cw G + j of its warp, states in its order
    order = _lane_order(n)                                  # (32, 4)
    chan = np.arange(dp)
    lane_of = ((chan % cpc) % w)[:, None] * g + np.arange(g)[None, :]
    states = order[lane_of]                                 # (dp, G, 4)
    warp_chan = np.arange(ctas * warps)[:, None] * w + np.arange(LANES) // g
    r, da = dhf.copy(), np.zeros((bsz, dp, n), np.float32)
    ddt, dx = np.zeros_like(dtf), np.zeros_like(xf)
    part = np.zeros((bsz, lp, ctas, 2 * n), np.float32)
    for s in reversed(range(segs)):
        hs = [ckpt[s]]
        for t in range(s * SEG, (s + 1) * SEG):
            hs.append(step(hs[-1], t))
        for k in reversed(range(SEG)):
            t = s * SEG + k
            hp, ht = hs[k], hs[k + 1]
            gt = dyf[:, t, :, None] * cf[:, t, None, :] + r
            vb, vc = gt * bx[:, t, :, None], dyf[:, t, :, None] * ht
            r = a_bar[:, t] * gt
            ga = r * hp
            da += ga * dtf[:, t, :, None]
            # the lane's sums over its states, in its order
            lg = gt[:, chan[:, None, None], states]          # (B, dp, G, 4)
            lb = np.broadcast_to(bf[:, t][:, states], lg.shape)
            lga = ga[:, chan[:, None, None], states]
            la = af[chan[:, None, None], states]
            dbx = np.zeros(lg.shape[:-1], np.float32)
            dsum = np.zeros_like(dbx)
            for i in range(4):
                dbx = lg[..., i] * lb[..., i] + dbx
                dsum = lga[..., i] * la[..., i] + dsum
            ddt[:, t] = _tree(dbx * xf[:, t, :, None] + dsum, 2)
            dx[:, t] = _tree(dbx * dtf[:, t, :, None], 2)
            # dB and dC: the butterfly in each warp, the warps in order
            pos = np.empty((bsz, ctas * warps, LANES, 8), np.float32)
            pos[..., 0::2] = vb[:, warp_chan[:, :, None], order[None]]
            pos[..., 1::2] = vc[:, warp_chan[:, :, None], order[None]]
            sums = _butterfly(pos, n).reshape(bsz, ctas, warps, 2 * n)
            acc = np.zeros((bsz, ctas, 2 * n), np.float32)
            for wi in range(warps):
                acc = acc + sums[:, :, wi]
            part[:, t] = acc
    # the reduce: a row's CTAs in strided runs, then a tree over the runs
    runs = SUM_THREADS // (2 * n)
    run = np.zeros((bsz, lp, runs, 2 * n), np.float32)
    for q in range(runs):
        for i in range(q, ctas, runs):
            run[:, :, q] = run[:, :, q] + part[:, :, i]
    sums = _tree(run, 2)[:, :length]
    db, dc = sums[..., :n], sums[..., n:]
    da_sum = da[0]
    if bsz > 1:
        da_sum = np.zeros((dp, n), np.float32)
        for i in range(bsz):
            da_sum = da_sum + da[i]
    out = (ddt[:, :length, :d], dx[:, :length, :d], db, dc, da_sum[:d],
           r[:, :d])
    return tuple(torch.from_numpy(np.ascontiguousarray(o)).to(t.dtype)
                 for o, t in zip(out, (dt, x, b, c, a, h0)))


@pytest.mark.parametrize("vals", [16, 32, 64, 128])
def test_butterfly_leaves_each_warp_sum_at_its_index(vals):
    """The butterfly and write-out for N = vals / 2: each lane's dB and
    dC terms placed in its state order, every written value is the sum
    over the warp's channels of the value at its index (dB then dC),
    and every index is written."""
    n = vals // 2
    g, w = n // 4, LANES // (n // 4)
    terms = np.random.default_rng(35).standard_normal(
        (3, w, 2, n)).astype(np.float32)                # (.., chan, k, n)
    order = _lane_order(n)
    lanes = np.arange(LANES)
    pos = np.empty((3, LANES, 8), np.float32)
    for k in range(2):
        pos[..., k::2] = terms[:, (lanes // g)[:, None], k, order]
    got = _butterfly(pos, n)
    np.testing.assert_allclose(got, terms.sum(axis=1).reshape(3, vals),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,d,n,inputs", [
    (1, 256, 256, 16, "hybrid"),   # the training chunk, D cut
    (1, 256, 256, 16, "sweep"),
    (2, 37, 100, 16, "sweep"),     # L off a segment, D off a CTA
    (2, 70, 96, 8, "sweep"),
    (1, 19, 64, 64, "sweep"),
    (2, 1, 40, 32, "sweep"),
    (2, 40, 72, 8, "sweep"),       # N 8: two lanes a channel, D off 64
    (1, 33, 48, 64, "sweep"),      # N 64: 16 lanes a channel, D off 32
    (3, 16, 130, 32, "sweep"),     # one whole segment, D off 64
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_arithmetic_meets_the_bar(b, s, d, n, inputs, dtype):
    """Why the kernel may take ex2.approx, replay checkpointed segments,
    sum a channel's states over its lanes and dB and dC by a butterfly,
    the warps in order and the CTAs in runs: with every a_t off by twice
    its documented error, its gradients stay within the card's bars of
    the plain reverse recurrence."""
    arrays = _inputs(36, b, s, d, n)
    if inputs == "hybrid":
        # layers.init_mamba: A = -exp(log(1..N)), dt = softplus(0.1 x - 2)
        rng = np.random.default_rng(37)
        arrays[0] = np.log1p(np.exp(0.1 * rng.standard_normal((b, s, d))
                                    - 2.0)).astype(np.float32)
        arrays[4] = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                                     (d, n)).copy()
    args = _torch_args(arrays, dtype)
    got = _bwd_kernel_arithmetic(*args, seed=38)
    _assert_rel(got, ref.mamba_scan_bwd_ref(*args), KERNEL_REL[dtype])


# -------------------------------------------------------------- the block

@pytest.fixture(scope="module")
def block():
    """The Jamba smoke config's Mamba layer: the port's ``init_mamba``
    parameters in both frameworks."""
    params = layers.init_mamba(torch.Generator().manual_seed(3),
                               get_smoke(JAMBA), torch.device("cpu"))
    return jax_get_smoke(JAMBA), {k: v.numpy() for k, v in params.items()}


@pytest.mark.parametrize("s", [128, 192, 96],
                         ids=["two-chunks", "three-chunks", "ragged"])
def test_mamba_block_gradients_match_jax(block, s):
    """jax.grad of the reference's mamba_block (its scan's gradient is
    autodiff of the associative scan) against the port's block through
    MambaScan: every parameter and the input, over chunks of ssm_chunk 64
    (the state's gradient crossing each chunk boundary), and over one
    ragged chunk."""
    jcfg, nparams = block
    cfg = get_smoke(JAMBA)
    rng = np.random.default_rng(39)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, _ = jax_layers.mamba_block(p, jcfg, xx)
        return jnp.sum(out * cot)

    jp = {k: jnp.asarray(v) for k, v in nparams.items()}
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in nparams.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    keys = sorted(params)
    out = layers.mamba_block(params, cfg, xt)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [params[k] for k in keys] + [xt])
    for name, g, e in zip(keys + ["x"], grads,
                          [jgp[k] for k in keys] + [jgx]):
        e = np.asarray(e, np.float32)
        scale = max(float(np.abs(e).max()), 1e-30)
        err = float(np.abs(g.numpy() - e).max())
        assert err <= REL["float32"] * scale, (name, err, scale)


def _rel_gap(got, exp) -> float:
    """The worst leaf's max |got - exp| over the leaf's largest |exp|."""
    return max(float(np.abs(np.asarray(g, np.float32)
                            - np.asarray(e, np.float32)).max())
               / max(float(np.abs(np.asarray(e, np.float32)).max()), 1e-30)
               for g, e in zip(got, exp))


def test_jamba_gradients_sit_between_the_reference_scans(monkeypatch):
    """Why tests/test_torch_train.py holds Jamba's leaves to 3e-5, not
    the file's 1e-5: on its smoke config at 2 x 128 tokens the
    reference's own two scans, the associative scan of its XLA path and
    its sequential oracle, give every leaf's gradient more than 5e-6 of
    the leaf's largest entry apart (the sums of the dt path over N
    cancel); the port's sequential scan is within 3e-5 of both."""
    jmodel = jax_build_model(jax_get_smoke(JAMBA))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(7).integers(
        0, jmodel.cfg.vocab_size, (2, 128)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens)}
    _, associative = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jbatch)

    def sequential(dt, x, b, c, a, h0):
        y, h = jax_ref.mamba_scan_ref(dt, x, b, c, a,
                                      h0.astype(jnp.float32))
        return y.astype(jnp.float32), h

    monkeypatch.setattr(jax_ops, "mamba_chunk", sequential)
    _, oracle = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jbatch)
    associative = jax.tree_util.tree_leaves(associative)
    oracle = jax.tree_util.tree_leaves(oracle)
    assert 5e-6 < _rel_gap(oracle, associative) < 3e-5

    model = build_model(get_smoke(JAMBA), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    _, grads = value_and_grad(model, params,
                              {"tokens": torch.from_numpy(tokens).long()})
    grads = [g.numpy() for g in grads]
    assert _rel_gap(grads, associative) < 3e-5
    assert _rel_gap(grads, oracle) < 3e-5
