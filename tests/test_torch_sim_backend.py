"""The port's torch backend of the planner sweep against the JAX
package's numpy engine: single fills, the exact percentile, the
candidate grid, the pipeline motifs and their analytic profiles, and
the Planner's and BeamPlanner's plans.

The contract is the reference's own for its device backend: bit
identity. Every comparison is exact (``np.array_equal``, ``==``). The
port runs with ``backend="torch", device="cpu"``, which takes the fill
kernel's plain torch version (:mod:`repro_torch.kernels.sim_fill`); the
card runs the kernel itself, held to the same plain version in
``tests/test_torch_gpu.py``. Inputs come from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.pipelines import (
    MOTIFS as REF_MOTIFS,
    arch_model_spec as ref_arch_model_spec,
    get_motif as ref_get_motif,
    transform_spec as ref_transform_spec,
)
from repro.core.hardware import HARDWARE_MENU as REF_MENU
from repro.core.pipeline import (
    PipelineConfig as RefPipelineConfig,
    StageConfig as RefStageConfig,
)
from repro.core.planner import BeamPlanner as RefBeamPlanner
from repro.core.planner import Planner as RefPlanner
from repro.core.profiler import analytic_batch_latency as ref_analytic
from repro.sim import SimEngine as RefSimEngine
from repro.sim import simulate_stage as ref_simulate_stage
from repro_torch.configs.pipelines import (
    MOTIFS,
    arch_model_spec,
    get_motif,
    hardware_menu_for,
    transform_spec,
)
from repro_torch.core.estimator import Estimator
from repro_torch.core.hardware import ANALYTIC_MENU, get_hardware
from repro_torch.core.pipeline import PipelineConfig, StageConfig
from repro_torch.core.planner import AnnealedPlanner, BeamPlanner, Planner
from repro_torch.core.profiler import (
    analytic_batch_latency,
    profile_model_analytic,
)
from repro_torch.kernels import sim_fill
from repro_torch.sim import SimEngine, simulate_stage
from repro_torch.sim import torch_backend as tb

CPU = torch.device("cpu")


@pytest.fixture
def forced(monkeypatch):
    """Single fills through the torch backend at every size."""
    monkeypatch.setattr(tb, "_FILL_THRESHOLD", 0)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of the static fill's plain version."""
    calls = []
    orig = sim_fill.fill_static_ref

    def spy(*a, **kw):
        calls.append(a[1])
        return orig(*a, **kw)

    monkeypatch.setattr(sim_fill, "fill_static_ref", spy)
    return calls


def _both(ready, lut, max_batch, replicas, replica_events=None,
          timeout_s=0.0):
    theirs = ref_simulate_stage("fifo", ready, lut, max_batch, replicas,
                                replica_events, timeout_s)
    ours = simulate_stage("fifo", ready, lut, max_batch, replicas,
                          replica_events, timeout_s, backend="torch",
                          device="cpu")
    for got, exp in zip(ours, theirs):
        assert np.array_equal(got, exp)
    return ours


def _ready(seed, n, scale, ties=0.2):
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(0.0, 0.05, n) * scale
    gaps[rng.random(n) < ties] = 0.0
    return np.cumsum(gaps)


def _lut(max_batch, base, slope):
    lut = np.full(max_batch + 1, -1.0)
    for b in range(1, max_batch + 1):
        lut[b] = base + slope * b
    return lut


# ------------------------------------------------------------------- fills

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("regime", ["underload", "critical", "overload"])
def test_static_fill_equals_the_reference(forced, plain_calls, seed, regime):
    rng = np.random.default_rng(100 + seed)
    scale = {"underload": 4.0, "critical": 1.0, "overload": 0.05}[regime]
    ready = _ready(seed, 60, scale)
    max_batch = int(rng.integers(1, 9))
    replicas = int(rng.integers(1, 5))
    timeout_s = (0.0, 0.03)[seed % 2]
    _both(ready, _lut(max_batch, 0.01, 0.004), max_batch, replicas,
          timeout_s=timeout_s)
    assert plain_calls


@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_batch_one_fill_equals_the_reference(forced, replicas):
    ready = _ready(replicas, 60, 0.5)
    _both(ready, _lut(1, 0.012, 0.0), 1, replicas)


@pytest.mark.parametrize("seed", range(6))
def test_dynamic_pool_fill_equals_the_reference(forced, seed):
    rng = np.random.default_rng(200 + seed)
    ready = _ready(seed, 60, 0.3)
    span = float(ready[-1]) if ready[-1] > 0 else 1.0
    max_batch = int(rng.integers(1, 7))
    events = [(float(rng.uniform(0.05, 0.45)) * span,
               int(rng.integers(1, 3))),
              (float(rng.uniform(0.5, 0.95)) * span, -1)]
    _both(ready, _lut(max_batch, 0.008, 0.003), max_batch,
          int(rng.integers(1, 4)), replica_events=events,
          timeout_s=(0.0, 0.02)[seed % 2])


def test_zero_replicas_with_scale_up_events(forced):
    ready = np.cumsum(np.full(40, 0.01))
    _both(ready, _lut(4, 0.01, 0.002), 4, 0, replica_events=[(0.15, 2)])


def test_scale_down_to_zero_starves_the_rest(forced):
    ready = np.cumsum(np.full(40, 0.01))
    done, batches, _ = _both(ready, _lut(4, 0.01, 0.002), 4, 1,
                             replica_events=[(0.1, -1)])
    assert done[-1] == 1e18 and batches.sum() < ready.size


def test_simultaneous_arrivals_and_ties(forced):
    ready = np.sort(np.concatenate(
        [np.cumsum(np.full(30, 0.02)), np.full(10, 0.3)]))
    _both(ready, _lut(8, 0.015, 0.001), 8, 2)


def test_inf_arrivals_and_one_query(forced):
    ready = np.concatenate([np.cumsum(np.full(20, 0.01)), np.full(5, np.inf)])
    _both(ready, _lut(4, 0.01, 0.002), 4, 2, timeout_s=0.02)
    _both(np.array([0.5]), _lut(4, 0.01, 0.002), 4, 3)


def test_negative_lut_goes_to_numpy(forced, plain_calls):
    ready = np.cumsum(np.full(32, 0.01))
    lut = _lut(4, 0.01, 0.002)
    lut[3] = -1.0
    _both(ready, lut, 4, 2)
    assert not plain_calls          # the reference's own route to numpy


def test_single_fills_stay_on_numpy_by_default(plain_calls):
    assert tb._FILL_THRESHOLD >= 1 << 62
    _both(np.cumsum(np.full(64, 0.01)), _lut(4, 0.01, 0.002), 4, 2)
    assert not plain_calls


def test_deadline_policies_ignore_the_backend():
    ready = np.cumsum(np.full(32, 0.01))
    lut = _lut(4, 0.01, 0.002)
    deadlines = ready + 0.25
    for policy in ("edf", "slo-drop"):
        want = ref_simulate_stage(policy, ready, lut, 4, 2,
                                  deadline=deadlines)
        got = simulate_stage(policy, ready, lut, 4, 2, deadline=deadlines,
                             backend="torch", device="cpu")
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_other_backends_raise_and_torch_needs_a_device():
    ready = np.cumsum(np.full(8, 0.01))
    for backend in ("jax", "tpu"):
        with pytest.raises(ValueError, match="backend"):
            simulate_stage("fifo", ready, _lut(2, 0.01, 0.001), 2, 1,
                           backend=backend)
    if torch.cuda.is_available():
        simulate_stage("fifo", ready, _lut(2, 0.01, 0.001), 2, 1,
                       backend="torch")
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            simulate_stage("fifo", ready, _lut(2, 0.01, 0.001), 2, 1,
                           backend="torch")


def test_static_plain_version_batches_and_lanes():
    """The grid entry's lanes are independent single fills: each row
    equals its one-lane fill, and the batch sizes sum to k."""
    ready = _ready(5, 80, 1.0)
    k = ready.size
    luts = [_lut(b, 0.01, 0.003) for b in (1, 4, 8)]
    pad = torch.from_numpy(np.concatenate([ready, np.full(8, np.inf)]))
    lut_rows = torch.zeros(3, 9, dtype=torch.float64)
    for i, lut in enumerate(luts):
        lut_rows[i, :lut.size] = torch.from_numpy(lut)
    pools = torch.full((3, 3), np.inf, dtype=torch.float64)
    for i, r in enumerate((1, 3, 2)):
        pools[i, :r] = 0.0
    done, batches, nb = sim_fill.fill_static(
        pad, k, lut_rows, torch.tensor([1, 4, 8]),
        torch.tensor([0.0, 0.02, 0.0], dtype=torch.float64), pools, True)
    for i, (b, r, t) in enumerate(((1, 1, 0.0), (4, 3, 0.02), (8, 2, 0.0))):
        want_done, want_batches, _ = ref_simulate_stage(
            "fifo", ready, luts[i], b, r, None, t)
        assert np.array_equal(done[i].numpy(), want_done)
        assert np.array_equal(batches[i, :int(nb[i])].numpy(), want_batches)
        assert int(batches[i].sum()) == k


# -------------------------------------------------------------- percentile

@pytest.mark.parametrize("seed", range(8))
def test_percentile_1d_equals_numpy(seed):
    rng = np.random.default_rng(300 + seed)
    vals = rng.uniform(-5.0, 5.0, int(rng.integers(1, 120)))
    for p in (0.0, 12.5, 50.0, 99.0, 99.9, 100.0, float(rng.uniform(0, 100))):
        assert tb.percentile_1d(vals, p, CPU) == float(np.percentile(vals, p))


@pytest.mark.parametrize("n_inf", [1, 2, 3])
def test_percentile_1d_with_inf_tail(n_inf):
    rng = np.random.default_rng(n_inf)
    vals = np.concatenate([rng.uniform(0.0, 2.0, 40), np.full(n_inf, np.inf)])
    for p in (90.0, 95.5, 99.0, 100.0):
        with np.errstate(invalid="ignore"):
            want = float(np.percentile(vals, p))
            got = tb.percentile_1d(vals, p, CPU)
        assert got == want or (np.isnan(got) and np.isnan(want))


# -------------------------------------------------------------------- grids

def _poisson(n, rate, seed):
    return np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, n))


def _grid(bound, cfg_cls, stage_cls, stage, hws, batches, reps, tmos=(0.0,)):
    base = cfg_cls({s: stage_cls(st.hardware_options[0], 1, 1)
                    for s, st in bound.pipeline.stages.items()})
    grid = []
    for hw in hws:
        for b in batches:
            for r in reps:
                for t in tmos:
                    cfg = base.copy()
                    cfg.stage_configs[stage] = stage_cls(hw, b, r,
                                                         timeout_s=t)
                    grid.append(cfg)
    return grid


def test_grid_percentiles_equal_the_reference_and_engage(monkeypatch,
                                                         plain_calls):
    monkeypatch.setattr(tb, "_GRID_MIN_CANDIDATES", 16)
    monkeypatch.setattr(tb, "_GRID_MIN_QUERIES", 256)
    arr = _poisson(1500, 60.0, seed=3)
    hws, batches, reps = ("tpu-v5e-8", "tpu-v5e-4"), (1, 4, 8), (1, 2, 3)
    tmos = (0.0, 0.01)
    ref = ref_get_motif("image-processing")
    want = RefSimEngine(ref.pipeline, ref.profiles).session(
        arr).percentile_many(_grid(ref, RefPipelineConfig, RefStageConfig,
                                   "classify", hws, batches, reps, tmos),
                             99.0)
    ours = get_motif("image-processing")
    grid = _grid(ours, PipelineConfig, StageConfig, "classify", hws,
                 batches, reps, tmos)
    sess = SimEngine(ours.pipeline, ours.profiles).session(
        arr, backend="torch", device="cpu")
    assert sess.percentile_many(grid, 99.0) == want
    assert plain_calls == [arr.size]          # one fill, every lane
    assert sess.grid_split["lanes"] == len(grid)
    assert sess.grid_split["chunks"] == 1
    assert sess.grid_split["launches"] == 2   # the fill and the select
    # the second pass is all cache hits, still equal
    assert sess.percentile_many(grid, 99.0) == want
    assert len(plain_calls) == 1


def test_grid_ineligible_goes_to_the_host_loop(monkeypatch, plain_calls):
    # two stages vary against the pivot: the grid declines and the host
    # loop serves the same answers
    monkeypatch.setattr(tb, "_GRID_MIN_CANDIDATES", 4)
    monkeypatch.setattr(tb, "_GRID_MIN_QUERIES", 0)
    arr = _poisson(600, 50.0, seed=5)
    grids = []
    for bound, cfg_cls, st_cls in (
            (ref_get_motif("image-processing"), RefPipelineConfig,
             RefStageConfig),
            (get_motif("image-processing"), PipelineConfig, StageConfig)):
        base = _grid(bound, cfg_cls, st_cls, "classify", ("tpu-v5e-8",),
                     (1,), (1,))[0]
        grid = []
        for b in (1, 2, 4):
            for pb in (1, 2):
                cfg = base.copy()
                cfg.stage_configs["classify"] = st_cls("tpu-v5e-8", b, 2)
                cfg.stage_configs["preprocess"] = st_cls("cpu-1", pb, 2)
                grid.append(cfg)
        grids.append(grid)
    ref = ref_get_motif("image-processing")
    want = RefSimEngine(ref.pipeline, ref.profiles).session(
        arr).percentile_many(grids[0], 99.0)
    ours = get_motif("image-processing")
    got = SimEngine(ours.pipeline, ours.profiles).session(
        arr, backend="torch", device="cpu").percentile_many(grids[1], 99.0)
    assert got == want
    assert not plain_calls


def test_session_simulate_parity_classed_trace(forced):
    # a whole session with a deadline policy in the pipeline: the fill
    # backend serves the fifo stage, numpy the slo-drop one
    arr = _poisson(800, 40.0, seed=11)
    slo_s = np.where(np.random.default_rng(12).random(arr.size) < 0.5,
                     0.15, 0.6)
    results = []
    for bound, cfg_cls, st_cls, eng, kw in (
            (ref_get_motif("image-processing"), RefPipelineConfig,
             RefStageConfig, RefSimEngine, {}),
            (get_motif("image-processing"), PipelineConfig, StageConfig,
             SimEngine, {"backend": "torch", "device": "cpu"})):
        cfg = _grid(bound, cfg_cls, st_cls, "classify", ("tpu-v5e-8",),
                    (4,), (2,))[0]
        cfg.stage_configs["preprocess"] = st_cls("cpu-1", 2, 2,
                                                 policy="slo-drop")
        results.append(eng(bound.pipeline, bound.profiles).session(
            arr, slo_s=slo_s, **kw).simulate(cfg))
    assert np.array_equal(results[0].latency, results[1].latency)


# ------------------------------------------------- motifs and their profiles

@pytest.mark.parametrize("motif", list(REF_MOTIFS))
def test_motifs_equal_the_reference(motif):
    assert list(MOTIFS) == list(REF_MOTIFS)
    ours, theirs = get_motif(motif), ref_get_motif(motif)
    assert ours.pipeline.name == theirs.pipeline.name
    assert list(ours.pipeline.stages) == list(theirs.pipeline.stages)
    for name, st in theirs.pipeline.stages.items():
        mine = ours.pipeline.stages[name]
        assert (mine.model_id, mine.hardware_options) == \
            (st.model_id, st.hardware_options)
        assert "h100-1" not in mine.hardware_options
    assert [(e.src, e.dst, e.probability) for e in ours.pipeline.edges] == \
        [(e.src, e.dst, e.probability) for e in theirs.pipeline.edges]
    assert ours.profiles.model_ids() == theirs.profiles.model_ids()
    for mid in theirs.profiles.model_ids():
        a, b = ours.profiles.get(mid), theirs.profiles.get(mid)
        assert a.table == b.table and a.batch_sizes == b.batch_sizes
        for hw in a.hardware_types():
            assert np.array_equal(a.latency_lut(hw, 128),
                                  b.latency_lut(hw, 128))


SPECS = [("pixtral-12b", 1040), ("llama3.2-1b", 256), ("phi3-mini-3.8b", 256),
         ("granite-moe-1b-a400m", 128), ("whisper-small", 448),
         ("xlstm-125m", 128), ("qwen2-72b", 256), ("granite-34b", 256)]


@pytest.mark.parametrize("arch,seq", SPECS)
def test_analytic_latency_equals_the_reference(arch, seq):
    ours, theirs = arch_model_spec(arch, seq), ref_arch_model_spec(arch, seq)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    prep, ref_prep = transform_spec("prep"), ref_transform_spec("prep")
    assert dataclasses.asdict(prep) == dataclasses.asdict(ref_prep)
    assert tuple(h.name for h in REF_MENU) == ANALYTIC_MENU
    for hw in REF_MENU:
        mine = get_hardware(hw.name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(hw)
        for b in (1, 2, 3, 8, 64, 128):
            assert analytic_batch_latency(ours, mine, b) == \
                ref_analytic(theirs, hw, b)
            assert analytic_batch_latency(prep, mine, b) == \
                ref_analytic(ref_prep, hw, b)
    assert "h100-1" not in hardware_menu_for(ours)


def test_the_card_is_priced_only_by_measurement():
    spec = arch_model_spec("llama3.2-1b", 256)
    for s in (spec, transform_spec("prep")):
        with pytest.raises(ValueError, match="measurement"):
            analytic_batch_latency(s, get_hardware("h100-1"), 8)
    with pytest.raises(ValueError, match="measurement"):
        profile_model_analytic(spec, hardware_options=("tpu-v5e-1",
                                                       "h100-1"))
    assert "h100-1" not in profile_model_analytic(spec).hardware_types()


# -------------------------------------------------------------------- plans

def _same_plan(a, b):
    assert a.feasible == b.feasible
    if a.feasible:
        assert a.config.cache_key() == b.config.cache_key()
        assert a.cost_per_hr == b.cost_per_hr
        assert a.estimated_p99 == b.estimated_p99


# (motif, trace seed, SLO, the fewest uncached candidates a grid needs
# to go to the device: each case's grids engage, fewer of them on the
# wider searches, to keep the plain version's CPU time down)
GREEDY = [("image-processing", 7, 0.5, 2), ("tf-cascade", 7, 0.5, 2)]
BEAM = [("image-processing", 9, 0.6, 7), ("video-monitoring", 9, 0.6, 16)]


@pytest.mark.parametrize("motif,seed,slo,min_cands", GREEDY)
def test_planner_plans_equal_the_reference(monkeypatch, plain_calls, motif,
                                           seed, slo, min_cands):
    monkeypatch.setattr(tb, "_GRID_MIN_CANDIDATES", min_cands)
    monkeypatch.setattr(tb, "_GRID_MIN_QUERIES", 0)
    arr = _poisson(6000, 40.0, seed)
    ref = ref_get_motif(motif)
    ours = get_motif(motif)
    _same_plan(Planner(ours.pipeline, ours.profiles, backend="torch",
                       device="cpu").plan(arr, slo),
               RefPlanner(ref.pipeline, ref.profiles).plan(arr, slo))
    assert plain_calls


@pytest.mark.parametrize("motif,seed,slo,min_cands", BEAM)
def test_beam_planner_plans_equal_the_reference(monkeypatch, plain_calls,
                                                motif, seed, slo, min_cands):
    monkeypatch.setattr(tb, "_GRID_MIN_CANDIDATES", min_cands)
    monkeypatch.setattr(tb, "_GRID_MIN_QUERIES", 0)
    arr = _poisson(6000, 40.0, seed)
    ref = ref_get_motif(motif)
    ours = get_motif(motif)
    _same_plan(BeamPlanner(ours.pipeline, ours.profiles, beam_width=4,
                           backend="torch", device="cpu").plan(arr, slo),
               RefBeamPlanner(ref.pipeline, ref.profiles,
                              beam_width=4).plan(arr, slo))
    assert plain_calls


def test_planner_backend_options():
    bound = get_motif("tf-cascade")
    assert BeamPlanner(bound.pipeline, bound.profiles).beam_width == 4
    assert BeamPlanner(bound.pipeline, bound.profiles, backend="torch",
                       device="cpu").beam_width == 8
    assert AnnealedPlanner(bound.pipeline, bound.profiles, backend="torch",
                           device="cpu").device == CPU
    est = Estimator(bound.pipeline, bound.profiles)
    sess = est.session(np.arange(10.0), backend="torch", device="cpu")
    assert (sess.backend, sess.device) == ("torch", CPU)
    for cls in (Planner, BeamPlanner, AnnealedPlanner):
        with pytest.raises(ValueError, match="backend"):
            cls(bound.pipeline, bound.profiles, backend="jax")
    with pytest.raises(ValueError, match="backend"):
        est.session(np.arange(10.0), backend="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            Planner(bound.pipeline, bound.profiles, backend="torch")
        with pytest.raises(RuntimeError, match="GPU"):
            est.session(np.arange(10.0), backend="torch")
