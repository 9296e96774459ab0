"""The planner sweep's select and latency rows, on the CPU.

``csrc/sim_select.cu`` cannot run here, so its arithmetic is emulated
in numpy, digit by digit: the order-preserving key map, the 8-bit MSB
radix passes with the two ranks sharing a histogram until their bins
part. The cluster path's emulation splits the row and the segment into
the warps' regions of the cluster's CTAs, starts below the prefix that
the cluster's least and greatest keys share, sums the CTAs' histograms,
compacts each warp's survivors and gathers them into CTA 0 once they
are few; it reads each row from device memory once. The stream path's
emulation copies the survivors once they fit (``cap``). The emulations,
the kernel's plain version (``sim_select.select_ref``) and the fill's
latency rows are held to the reference's numpy with ``==``, and
``grid_stage_percentiles`` (plain versions) to the reference's
``repro.sim.jax_backend.grid_stage_percentiles``, queries that skip the
stage included.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _hyp import given, settings, st  # hypothesis or deterministic fallback
from repro.sim import jax_backend as ref_jb
from repro.sim import simulate_stage as ref_simulate_stage
from repro_torch.kernels import sim_fill, sim_select
from repro_torch.sim import torch_backend as tb

FAR = 1e18
SIGN = np.uint64(1 << 63)
ALL = np.uint64((1 << 64) - 1)
BITS, BINS, DIGITS = 8, 256, 8
KERNEL_CAP = 8192
# the cluster path's sizes (csrc/sim_select.cu)
CLUSTER, WARPS, REGION_CAP, GATHER = 16, 8, 3072, 1024
WIDE_BITS = 11          # the cluster path's first digit
CLUSTER_CAP = CLUSTER * WARPS * REGION_CAP


# ----------------------------------------------------------- the emulation

def order_keys(x: np.ndarray) -> np.ndarray:
    """The kernel's ``order_key``: non-negatives set the sign bit,
    negatives flip every bit, NaN goes above +inf."""
    x = np.asarray(x, dtype=np.float64)
    u = x.view(np.uint64)
    keys = np.where(u & SIGN, ~u, u | SIGN)
    keys[np.isnan(x)] = ALL
    return keys


def key_values(keys: np.ndarray) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.uint64)
    return np.where(keys & SIGN, keys ^ SIGN, ~keys).view(np.float64)


def find_bin(hist: np.ndarray, rank: int) -> tuple:
    """Warp 0's search: lane l sums the l-th len(hist) / 32 bins, an
    inclusive scan over the lanes, the lane whose range holds ``rank``
    walks its bins. Returns (bin, count of the bins before it)."""
    per = hist.size // 32
    sums = hist.reshape(32, per).sum(1)
    inc = np.cumsum(sums)
    exc = inc - sums
    lane = int(np.nonzero((exc <= rank) & (rank < inc))[0][0])
    acc = int(exc[lane])
    for j in range(per):
        c = int(hist[per * lane + j])
        if rank < acc + c:
            return per * lane + j, acc
        acc += c
    raise AssertionError("rank past the histogram")


def radix_select(row: np.ndarray, seg: np.ndarray, r0: int, r1: int,
                 cap: int = KERNEL_CAP) -> tuple:
    """The kernel's passes over one row and the segment: the values of
    ranks r0 <= r1, and the passes that read the row from device
    memory."""
    keys_all = order_keys(np.concatenate([row, seg]))
    prefix = [np.uint64(0), np.uint64(0)]
    rank = [r0, r1]
    split = False
    source = "global"
    buf = None
    global_passes = 0
    for d in range(DIGITS):
        shift = np.uint64(64 - BITS * (d + 1))
        hmask = np.uint64(0) if d == 0 else \
            ALL << np.uint64(64 - BITS * d)
        keys = buf if source == "shared" else keys_all
        global_passes += source != "shared"
        top = keys & hmask
        digit = ((keys >> shift) & np.uint64(BINS - 1)).astype(np.int64)
        in0 = top == prefix[0]
        in1 = (top == prefix[1]) if split else np.zeros_like(in0)
        if source == "compact":
            buf = keys[in0 | in1]
        h0 = np.bincount(digit[in0], minlength=BINS)
        h1 = np.bincount(digit[in1], minlength=BINS) if split else h0
        b0, below0 = find_bin(h0, rank[0])
        b1, below1 = find_bin(h1, rank[1])
        p1 = prefix[1] if split else prefix[0]
        prefix = [prefix[0] | (np.uint64(b0) << shift),
                  p1 | (np.uint64(b1) << shift)]
        rank = [rank[0] - below0, rank[1] - below1]
        left = h0[b0] + (h1[b1] if split else (h0[b1] if b1 != b0 else 0))
        split = split or b1 != b0
        if source == "compact":
            source = "shared"
        elif source == "global" and left <= cap:
            source = "compact"
    vals = key_values(np.array(prefix, dtype=np.uint64))
    return float(vals[0]), float(vals[1]), global_passes


def _mask(rem: int) -> np.uint64:
    """The key bits above the lowest ``rem``."""
    return np.uint64(0) if rem == 64 else ALL << np.uint64(rem)


def cluster_select(row: np.ndarray, seg: np.ndarray, r0: int, r1: int,
                   cluster: int = CLUSTER, warps: int = WARPS,
                   gather: int = GATHER) -> tuple:
    """The cluster path over one row and the segment: the values of
    ranks r0 <= r1, and the passes over the cluster's shared memory
    before and after the gather into CTA 0, whose warp 0 finishes alone
    (the row is read from device memory once, by the copy). The first
    pass counts a digit of WIDE_BITS; the kernel finds its bin in two
    steps (a group of 32 bins, then the bin), which is this search."""
    keys_all = order_keys(np.concatenate([row, seg]))
    n = keys_all.size
    region = -(-n // (cluster * warps))
    lists = [keys_all[g * region:(g + 1) * region]
             for g in range(cluster * warps)]
    cta = [g // warps for g in range(cluster * warps)]
    lo = min(int(ks.min()) for ks in lists if ks.size)
    hi = max(int(ks.max()) for ks in lists if ks.size)
    rem = (lo ^ hi).bit_length()
    prefix = [np.uint64(lo) & _mask(rem)] * 2
    rank = [r0, r1]
    split, local = False, False
    passes = [0, 0]                       # cluster-wide, CTA 0 alone
    while rem > 0:
        first = passes == [0, 0]          # counts all, compacts none
        bins = 1 << WIDE_BITS if first else BINS
        hmask = _mask(rem)
        width = min(WIDE_BITS if first else BITS, rem)
        shift = rem - width
        dmask = np.uint64((1 << width) - 1)
        hists = np.zeros((1 if local else cluster, 2 * bins), np.int64)
        sets = [[], []]                   # each rank's survivors
        for g, keys in enumerate(lists):
            top = keys & hmask
            digit = ((keys >> np.uint64(shift)) & dmask).astype(np.int64)
            in0 = top == prefix[0]
            in1 = (top == prefix[1]) & ~in0 if split else \
                np.zeros_like(in0)
            h = hists[0 if local else cta[g]]
            h[:bins] += np.bincount(digit[in0], minlength=bins)
            h[bins:] += np.bincount(digit[in1], minlength=bins)
            sets[0].append(keys[in0])
            sets[1].append(keys[in1])
            lists[g] = keys[in0 | in1]    # compacted in place, in order
        passes[local] += 1
        ends = [np.concatenate(sets[i]) for i in (0, 1 if split else 0)]
        tot = hists.sum(0)
        h0, h1 = tot[:bins], tot[bins:] if split else tot[:bins]
        b0, below0 = find_bin(h0, rank[0])
        b1, below1 = find_bin(h1, rank[1])
        # a rank's value is known where its survivors are one key
        # repeated, or, CTA 0 alone, where it is its bin's least or
        # greatest key; ~0 (NaN) is left to the prefixes
        found = [None, None]
        for r, (e, b, below) in enumerate(((ends[0], b0, below0),
                                           (ends[1], b1, below1))):
            if not first and e.min() == e.max():
                found[r] = e.min()
            elif local:
                inbin = e[((e >> np.uint64(shift)) & dmask) == b]
                if rank[r] - below == 0 or inbin.min() == inbin.max():
                    found[r] = inbin.min()
                elif rank[r] - below == inbin.size - 1:
                    found[r] = inbin.max()
            if found[r] is not None and found[r] == ALL:
                found[r] = None
        if found[0] is not None and found[1] is not None:
            prefix = found
            break
        p1 = prefix[1] if split else prefix[0]
        prefix = [prefix[0] | (np.uint64(b0) << np.uint64(shift)),
                  p1 | (np.uint64(b1) << np.uint64(shift))]
        rank = [rank[0] - below0, rank[1] - below1]
        left = h0[b0] + (h1[b1] if split else (h0[b1] if b1 != b0 else 0))
        split = split or b1 != b0
        rem = shift
        if not local and rem > 0 and left <= gather:
            gmask = _mask(rem)
            got = np.concatenate([ks[((ks & gmask) == prefix[0]) |
                                     ((ks & gmask) == prefix[1])]
                                  for ks in lists])
            assert got.size == left
            lists = [got]                 # warp 0 of CTA 0 alone
            local = True
    vals = key_values(np.array(prefix, dtype=np.uint64))
    return float(vals[0]), float(vals[1]), tuple(passes)


def kernel_select(row: np.ndarray, seg: np.ndarray, r0: int,
                  r1: int) -> tuple:
    """The kernel's choice of path by k + m: the values of ranks r0 <=
    r1, the path, and its reads of the row from device memory."""
    if row.size + seg.size <= CLUSTER_CAP:
        a, b, _ = cluster_select(row, seg, r0, r1)
        return a, b, "cluster", 1
    a, b, reads = radix_select(row, seg, r0, r1)
    return a, b, "stream", reads


def partition_pair(row: np.ndarray, seg: np.ndarray, r0: int,
                   r1: int) -> tuple:
    """The reference's selection: ``np.partition(lat, kth)`` read at the
    two ranks."""
    lat = np.concatenate([row, seg])
    part = np.partition(lat, (r0, r1) if r1 > r0 else (r0,))
    return float(part[r0]), float(part[r1])


def _same(a: float, b: float) -> bool:
    return a == b or (np.isnan(a) and np.isnan(b))


# values with many ties, both infinities and the fill's FAR_FUTURE
_POOL = [0.0, 0.0125, 0.0125, 0.25, 1.5, 1.5, -2.0, np.inf, -np.inf, FAR,
         FAR, 3e-9, 7.0]
_values = st.lists(
    st.integers(min_value=0, max_value=2 * len(_POOL) - 1).map(
        lambda i: _POOL[i] if i < len(_POOL)
        else (i - len(_POOL)) * 0.37 - 1.1),
    min_size=1, max_size=300)


@settings(max_examples=60, deadline=None)
@given(_values, st.floats(min_value=0.0, max_value=100.0),
       st.integers(min_value=0, max_value=40))
def test_radix_select_emulation_equals_partition(values, p, n_seg):
    n_seg = min(n_seg, len(values) - 1)
    vals = np.asarray(values, dtype=np.float64) + 0.0    # no -0.0
    row, seg = vals[n_seg:], vals[:n_seg]
    prev, nxt, _ = tb._quantile_params(vals.size, p)
    want = partition_pair(row, seg, prev, nxt)
    for cap in (4, KERNEL_CAP):
        a, b, _ = radix_select(row, seg, prev, nxt, cap)
        assert (a, b) == want, (cap, prev, nxt)


# (cluster, gather): one CTA, two, the kernel's 16; a gather of one key,
# of a few, the kernel's
_CLUSTER_SHAPES = [(1, 1), (2, 4), (16, 1), (16, GATHER)]


@settings(max_examples=60, deadline=None)
@given(_values, st.floats(min_value=0.0, max_value=100.0),
       st.integers(min_value=0, max_value=40))
def test_cluster_emulation_equals_partition(values, p, n_seg):
    """The cluster path: regions of the row and the segment over the
    CTAs' warps, summed histograms, compaction, the gather."""
    n_seg = min(n_seg, len(values) - 1)
    vals = np.asarray(values, dtype=np.float64) + 0.0    # no -0.0
    row, seg = vals[n_seg:], vals[:n_seg]
    prev, nxt, _ = tb._quantile_params(vals.size, p)
    want = partition_pair(row, seg, prev, nxt)
    for cluster, gather in _CLUSTER_SHAPES:
        a, b, _ = cluster_select(row, seg, prev, nxt, cluster, WARPS, gather)
        assert all(_same(x, y) for x, y in zip((a, b), want)), \
            (cluster, gather, prev, nxt)


def _edge_rows():
    rng = np.random.default_rng(11)
    lat = rng.gamma(2.0, 0.05, 5000)
    ties = np.repeat(rng.uniform(0.01, 0.2, 40), 125)
    return {
        "ties": (ties, np.empty(0)),
        "inf tail": (np.concatenate([lat, np.full(60, np.inf)]), np.empty(0)),
        "FAR_FUTURE tail": (np.concatenate([lat, np.full(90, FAR)]),
                            np.empty(0)),
        "n = 1": (np.array([0.75]), np.empty(0)),
        "k < n": (lat[:3000], lat[3000:] + 0.5),
        "all equal": (np.full(4000, 0.125), np.empty(0)),
    }


@pytest.mark.parametrize("name", list(_edge_rows()))
@pytest.mark.parametrize("p", [0.0, 50.0, 99.0, 100.0])
def test_radix_select_edge_rows(name, p):
    row, seg = _edge_rows()[name]
    prev, nxt, _ = tb._quantile_params(row.size + seg.size, p)
    want = partition_pair(row, seg, prev, nxt)
    a, b, passes = radix_select(row, seg, prev, nxt)
    assert (a, b) == want
    assert 1 <= passes <= DIGITS


def test_survivors_leave_device_memory_after_a_few_passes():
    """At the sweep's 107,487 latencies a row fits the cluster's shared
    memory: the kernel reads it from device memory once, and every
    radix pass runs from shared memory."""
    rng = np.random.default_rng(3)
    row = rng.gamma(2.0, 0.05, 107487)
    prev, nxt, _ = tb._quantile_params(row.size, 99.0)
    a, b, path, reads = kernel_select(row, np.empty(0), prev, nxt)
    assert (a, b) == partition_pair(row, np.empty(0), prev, nxt)
    assert path == "cluster" and reads == 1


@pytest.mark.parametrize("name", list(_edge_rows()))
@pytest.mark.parametrize("p", [0.0, 50.0, 99.0, 100.0])
def test_cluster_select_edge_rows(name, p):
    row, seg = _edge_rows()[name]
    prev, nxt, _ = tb._quantile_params(row.size + seg.size, p)
    want = partition_pair(row, seg, prev, nxt)
    for cluster, gather in _CLUSTER_SHAPES:
        a, b, passes = cluster_select(row, seg, prev, nxt, cluster, WARPS,
                                      gather)
        assert (a, b) == want, (cluster, gather)
        assert sum(passes) <= DIGITS


def _sweep_row(dist: str) -> np.ndarray:
    rng = np.random.default_rng(29)
    n = 107487
    if dist == "gamma":
        return rng.gamma(2.0, 0.05, n)
    if dist == "lognormal":
        return rng.lognormal(-2.5, 0.8, n)
    if dist == "ties":
        return np.round(rng.gamma(2.0, 0.05, n), 2)
    if dist == "FAR_FUTURE tail":
        return np.concatenate([rng.gamma(2.0, 0.05, n - 1500),
                               np.full(1500, FAR)])
    return np.concatenate([rng.gamma(2.0, 0.05, n - 2000),
                           np.full(2000, np.inf)])


@pytest.mark.parametrize("dist", ["gamma", "lognormal", "ties",
                                  "FAR_FUTURE tail", "inf tail"])
@pytest.mark.parametrize("p", [50.0, 99.0])
def test_sweep_rows_are_read_once(dist, p):
    """Rows of the sweep's length take the cluster path whatever their
    spread or ties: one read, a few passes over the cluster's shared
    memory (a run of equal keys ends the passes), the rest in CTA 0."""
    row = _sweep_row(dist)
    prev, nxt, _ = tb._quantile_params(row.size, p)
    a, b, path, reads = kernel_select(row, np.empty(0), prev, nxt)
    assert (a, b) == partition_pair(row, np.empty(0), prev, nxt)
    assert path == "cluster" and reads == 1
    _, _, passes = cluster_select(row, np.empty(0), prev, nxt)
    assert passes[0] <= 3 and sum(passes) <= 6, passes


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_rows_at_the_cluster_capacity(offset):
    """k + m at the cluster's capacity -1, at it and +1: the segment
    spans CTAs, k is no multiple of the cluster size; the last size
    streams from device memory."""
    rng = np.random.default_rng(31)
    m = 5001
    k = CLUSTER_CAP + offset - m
    assert k % CLUSTER
    row = rng.gamma(2.0, 0.05, k)
    row[-3000:] = FAR
    seg = rng.gamma(2.0, 0.05, m) + 0.2
    for p in (50.0, 99.0, 100.0):
        prev, nxt, _ = tb._quantile_params(k + m, p)
        a, b, path, reads = kernel_select(row, seg, prev, nxt)
        assert (a, b) == partition_pair(row, seg, prev, nxt), p
        assert path == ("cluster" if offset <= 0 else "stream")
        assert path == sim_select.path(k + m)
        assert (reads == 1) if offset <= 0 else (2 <= reads <= DIGITS)


@pytest.mark.parametrize("k,m", [(1, 0), (1, 300), (37, 2000), (4097, 0),
                                 (255, 1025)])
def test_cluster_select_splits_the_segment_across_ctas(k, m):
    """Short rows and long segments: a warp's region may hold the row's
    end and the segment's start, or the segment alone, or nothing."""
    rng = np.random.default_rng(k + m)
    row = rng.gamma(2.0, 0.05, k)
    seg = np.round(rng.gamma(2.0, 0.05, m), 3)
    for p in (0.0, 50.0, 99.0, 100.0):
        prev, nxt, _ = tb._quantile_params(k + m, p)
        want = partition_pair(row, seg, prev, nxt)
        for cluster, gather in _CLUSTER_SHAPES:
            assert cluster_select(row, seg, prev, nxt, cluster, WARPS,
                                  gather)[:2] == want, (p, cluster, gather)


def test_cluster_sizes_match_the_cuda_source():
    """The emulation's and the wrapper's sizes are the kernel's."""
    text = (Path(sim_select.__file__).parent / "csrc" /
            "sim_select.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert (const("kCluster"), const("kWarps"), const("kRegionCap"),
            const("kGather"), const("kWideBits")) == (
                CLUSTER, WARPS, REGION_CAP, GATHER, WIDE_BITS)
    assert (sim_select.CLUSTER, sim_select.CLUSTER_CAP) == (CLUSTER,
                                                            CLUSTER_CAP)
    assert sim_select.path(CLUSTER_CAP) == "cluster"
    assert sim_select.path(CLUSTER_CAP + 1) == "stream"


def test_order_keys_order_as_numpy_sorts():
    x = np.array([-np.inf, -3.5, -1e-300, 0.0, 5e-324, 1.0, FAR, np.inf,
                  np.nan])
    keys = order_keys(x)
    assert np.all(keys[1:] > keys[:-1])
    back = key_values(keys)
    assert np.array_equal(back[:-1], x[:-1]) and np.isnan(back[-1])


# -------------------------------------------------------- the plain select

@pytest.mark.parametrize("name", list(_edge_rows()))
@pytest.mark.parametrize("p", [0.0, 50.0, 99.0, 100.0])
def test_plain_select_equals_partition(name, p):
    row, seg = _edge_rows()[name]
    rows = np.stack([row, row[::-1].copy(), np.sort(row)])
    prev, nxt, _ = tb._quantile_params(row.size + seg.size, p)
    got = sim_select.select(torch.from_numpy(rows), torch.from_numpy(seg),
                            prev, nxt).numpy()
    for i in range(rows.shape[0]):
        assert tuple(got[i]) == partition_pair(rows[i], seg, prev, nxt)


def test_plain_select_puts_nan_last_as_numpy():
    row = np.array([0.5, np.nan, 0.25, np.inf, 0.25])
    got = sim_select.select(torch.from_numpy(row[None]),
                            torch.empty(0, dtype=torch.float64), 3, 4)[0]
    want = partition_pair(row, np.empty(0), 3, 4)
    assert all(_same(float(g), w) for g, w in zip(got, want))
    assert all(_same(g, w) for g, w in zip(
        radix_select(row, np.empty(0), 3, 4)[:2], want))


def test_cluster_select_puts_nan_last_as_numpy():
    rng = np.random.default_rng(5)
    row = np.concatenate([rng.gamma(2.0, 0.05, 400), np.full(9, np.nan),
                          [np.inf, 0.25, 0.25]])
    for r0, r1 in ((3, 4), (400, 411), (402, 403), (411, 411)):
        want = partition_pair(row, np.empty(0), r0, r1)
        for cluster, gather in _CLUSTER_SHAPES:
            got = cluster_select(row, np.empty(0), r0, r1, cluster, WARPS,
                                 gather)[:2]
            assert all(_same(g, w) for g, w in zip(got, want)), (r0, r1)


# ---------------------------------------------------- latency rows, grids

def _fill_lut(max_batch):
    return np.array([0.0] + [0.004 + 0.0005 * b
                             for b in range(1, max_batch + 1)])


def _stage_inputs(seed, n, k):
    """A sink stage's queue: k of n arrivals reach it (conditional
    routing) after an upstream delay; base_last is the other stages'
    completion maximum, at least the arrival."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1 / 120.0, n))
    base_last = arrivals + rng.gamma(2.0, 0.01, n)
    idx = np.sort(rng.choice(n, k, replace=False))
    ready = arrivals.copy()
    ready[idx] += rng.gamma(2.0, 0.004, k)
    order = idx[np.argsort(ready[idx], kind="stable")]
    return ready[order], order, base_last, arrivals


LANES = [(1, 1, 0.0), (4, 2, 0.01), (8, 3, 0.0), (8, 1, 0.005), (2, 40, 0.0)]


def test_plain_latency_rows_equal_the_reference_assembly():
    sorted_ready, order, base_last, arrivals = _stage_inputs(5, 900, 700)
    k, n, rpc = sorted_ready.size, arrivals.size, 0.0015
    effs = [e for e, _, _ in LANES]
    arrays = tb.lane_inputs([_fill_lut(e) for e in effs], effs,
                            [r for _, r, _ in LANES],
                            [t for _, _, t in LANES])
    pad = np.concatenate([sorted_ready, np.full(max(effs), np.inf)])
    pad, luts, eff, tmo, pools = (torch.from_numpy(a) for a in (pad, *arrays))
    lat = sim_fill.fill_latency(pad, k, luts, eff, tmo, pools,
                                torch.from_numpy(base_last[order]),
                                torch.from_numpy(arrivals[order]), rpc)
    assert lat.shape == (len(LANES), k)
    for i, (e, r, t) in enumerate(LANES):
        done, _, _ = ref_simulate_stage("fifo", sorted_ready, _fill_lut(e),
                                        e, r, None, t)
        comp = np.full(n, -np.inf)
        comp[order] = done
        want = np.maximum(base_last, comp) - arrivals + rpc
        assert np.array_equal(lat[i].numpy(), want[order]), (e, r, t)


def test_latency_rows_refuse_a_negative_rpc():
    pad = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="rpc"):
        sim_fill.fill_latency(pad, 2, torch.zeros(1, 2, dtype=torch.float64),
                              torch.ones(1, dtype=torch.int64),
                              torch.zeros(1, dtype=torch.float64),
                              torch.zeros(1, 1, dtype=torch.float64),
                              pad[:2], pad[:2], -1e-3)


@pytest.fixture
def ref_grid(monkeypatch):
    """The reference's device grid, its scans run by JAX on the CPU. The
    installed jax has no ``jax.experimental.enable_x64``, the context
    that the module imports (so it binds ``jax`` to None); its
    successor, ``jax.enable_x64(True)``, is the same switch. The module
    is patched for this test only, its code untouched."""
    import jax

    monkeypatch.setattr(ref_jb, "jax", jax)
    monkeypatch.setattr(ref_jb, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    monkeypatch.setattr(ref_jb, "_HAVE_JAX", True)
    return ref_jb.grid_stage_percentiles


@pytest.mark.parametrize("n,k", [(900, 900), (900, 640)])
def test_grid_percentiles_equal_the_reference(ref_grid, n, k):
    """The torch grid (plain versions on the CPU) against the reference's
    device grid, with queries that skip the stage when k < n."""
    sorted_ready, order, base_last, arrivals = _stage_inputs(7, n, k)
    effs = [e for e, _, _ in LANES]
    args = (sorted_ready, order, base_last, arrivals, 0.002,
            [_fill_lut(e) for e in effs], effs, [r for _, r, _ in LANES],
            [t for _, _, t in LANES])
    for p in (0.0, 50.0, 99.0, 100.0):
        split = {}
        got = tb.grid_stage_percentiles(*args, p, torch.device("cpu"),
                                        split=split)
        want = ref_grid(*args, p)
        assert np.array_equal(got, want), p
        assert split == {"chunks": 1, "launches": 2, "lanes": len(LANES),
                         "queries": k}


def test_grid_chunks_make_two_launches_each(monkeypatch):
    """A grid larger than one chunk's bytes runs in chunks of whole
    lanes, a fill and a select each, with the same answers."""
    sorted_ready, order, base_last, arrivals = _stage_inputs(9, 500, 420)
    effs = [e for e, _, _ in LANES]
    args = (sorted_ready, order, base_last, arrivals, 0.0,
            [_fill_lut(e) for e in effs], effs, [r for _, r, _ in LANES],
            [t for _, _, t in LANES], 99.0, torch.device("cpu"))
    whole = tb.grid_stage_percentiles(*args)
    monkeypatch.setattr(tb, "_GRID_OUT_BYTES", 2 * 8 * 420)
    split = {}
    assert np.array_equal(tb.grid_stage_percentiles(*args, split=split),
                          whole)
    assert split["chunks"] == 3 and split["launches"] == 6
