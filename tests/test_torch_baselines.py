"""The port's copies of the paper's baselines and workload traces against
the JAX package's: the coarse-grained planner and tuner, DS2, the
AutoScale-derived traces and the time-varying generators. Both packages
are host numpy code, so every comparison is exact (``==``,
``np.array_equal``), never a tolerance.

The pipelines and profiles are the reference's ``image_pipeline`` and
``social_pipeline`` fixtures (``tests/conftest.py``) and its traces, as
``tests/test_baselines.py`` and ``tests/test_workload.py`` use them;
each profile table is copied into the port's ``ModelProfile``."""

import numpy as np
import pytest

from repro.baselines import coarse_grained as ref_cg
from repro.baselines import ds2 as ref_ds2
from repro.workload import generator as ref_gen
from repro.workload import traces as ref_traces
from repro_torch.baselines import coarse_grained as cg
from repro_torch.baselines import ds2
from repro_torch.core.estimator import Estimator
from repro_torch.core.pipeline import (
    Edge,
    Pipeline,
    Stage,
    linear_pipeline,
)
from repro_torch.core.profiler import ModelProfile, ProfileStore
from repro_torch.workload import generator, traces

SLO = 0.15


def port_store(ref_store) -> ProfileStore:
    store = ProfileStore()
    for mid in ref_store.model_ids():
        prof = ref_store.get(mid)
        store.add(ModelProfile(mid, dict(prof.table),
                               tuple(prof.batch_sizes)))
    return store


def port_pipeline(ref_pipe) -> Pipeline:
    if ref_pipe.name == "image-processing":
        return linear_pipeline(ref_pipe.name, [
            st.model_id for st in ref_pipe.stages.values()])
    return Pipeline(ref_pipe.name,
                    {n: Stage(n, st.model_id)
                     for n, st in ref_pipe.stages.items()},
                    [Edge(e.src, e.dst, e.probability)
                     for e in ref_pipe.edges])


@pytest.fixture(scope="module", params=["image", "social"])
def both(request, image_pipeline, social_pipeline):
    """(reference pipeline, reference store, port pipeline, port store)."""
    ref_pipe, ref_store = {"image": image_pipeline,
                           "social": social_pipeline}[request.param]
    return ref_pipe, ref_store, port_pipeline(ref_pipe), port_store(ref_store)


def stage_tuples(config):
    return {s: (c.hardware, c.batch_size, c.replicas, c.timeout_s, c.policy)
            for s, c in config.stage_configs.items()}


def assert_same_cg_plan(ours, theirs):
    assert (ours.feasible, ours.unit_batch, ours.unit_throughput,
            ours.unit_replicas, ours.cost_per_hr) == \
        (theirs.feasible, theirs.unit_batch, theirs.unit_throughput,
         theirs.unit_replicas, theirs.cost_per_hr)
    assert (ours.config is None) == (theirs.config is None)
    if theirs.config is not None:
        assert stage_tuples(ours.config) == stage_tuples(theirs.config)


def ds2_hardware(pipe):
    return {s: ("cpu-1" if "prep" in s else "tpu-v5e-1") for s in pipe.stages}


# ----------------------------------------------------------- coarse-grained

@pytest.mark.parametrize("strategy", ["mean", "peak"])
@pytest.mark.parametrize("trace", ["sample", "bursty"])
def test_cg_plans_match_the_reference(both, strategy, trace, sample_trace,
                                      bursty_trace):
    ref_pipe, ref_store, pipe, store = both
    arrivals = {"sample": sample_trace, "bursty": bursty_trace}[trace]
    theirs = ref_cg.CGPlanner(ref_pipe, ref_store).plan(arrivals, SLO,
                                                        strategy)
    ours = cg.CGPlanner(pipe, store).plan(arrivals, SLO, strategy)
    assert theirs.feasible
    assert_same_cg_plan(ours, theirs)
    assert_same_cg_plan(cg.cg_plan(pipe, store, arrivals, SLO, strategy),
                        theirs)
    # a planner handed an Estimator reuses its engine, with the same plan
    est = Estimator(pipe, store)
    planner = cg.CGPlanner(pipe, store, estimator=est)
    assert planner.engine is est.engine
    assert_same_cg_plan(planner.plan(arrivals, SLO, strategy), theirs)


@pytest.mark.parametrize("slo", [1e-5, 0.02, 1.0])
def test_cg_edge_slos_match_the_reference(image_pipeline, sample_trace, slo):
    ref_pipe, ref_store = image_pipeline
    theirs = ref_cg.CGPlanner(ref_pipe, ref_store).plan(sample_trace, slo)
    ours = cg.CGPlanner(port_pipeline(ref_pipe),
                        port_store(ref_store)).plan(sample_trace, slo)
    assert_same_cg_plan(ours, theirs)


def test_cg_unknown_strategy_raises(image_pipeline, sample_trace):
    ref_pipe, ref_store = image_pipeline
    with pytest.raises(ValueError, match="unknown CG strategy"):
        cg.CGPlanner(port_pipeline(ref_pipe), port_store(ref_store)).plan(
            sample_trace, SLO, strategy="median")


@pytest.mark.parametrize("seed", [1, 2])
def test_cg_tuner_schedules_match_the_reference(both, seed):
    """CGTuner's decisions on a rate ramp, step by step, and the
    offline schedule of run_cg_tuner_offline."""
    ref_pipe, ref_store, pipe, store = both
    sample = ref_gen.gamma_trace(150, 1.0, 60, seed=0)
    ramp = ref_gen.rate_ramp_trace(150, 300, 1.0, pre_s=30, ramp_s=20,
                                   post_s=60, seed=seed)
    ref_plan = ref_cg.CGPlanner(ref_pipe, ref_store).plan(sample, SLO,
                                                          strategy="mean")
    plan = cg.CGPlanner(pipe, store).plan(sample, SLO, strategy="mean")
    theirs = ref_cg.CGTuner(ref_plan, hysteresis_s=20.0)
    ours = cg.CGTuner(plan, hysteresis_s=20.0)
    for now in np.arange(10.0, 120.0, 5.0):
        seen = ramp[ramp <= now]
        assert ours.step(now, seen) == theirs.step(now, seen)
        assert ours.last_change_t == theirs.last_change_t
    assert cg.run_cg_tuner_offline(cg.CGTuner(plan), pipe, ramp) == \
        ref_cg.run_cg_tuner_offline(ref_cg.CGTuner(ref_plan), ref_pipe,
                                    ramp)
    with pytest.raises(ValueError, match="infeasible"):
        cg.CGTuner(cg.CGPlan(None, 0, 0.0, 0, False))


# ---------------------------------------------------------------------- DS2

@pytest.mark.parametrize("lam,cv,seed", [(100, 1.0, 2), (100, 4.0, 3),
                                         (250, 2.0, 4)])
def test_ds2_decisions_match_the_reference(image_pipeline, lam, cv, seed):
    ref_pipe, ref_store = image_pipeline
    pipe, store = port_pipeline(ref_pipe), port_store(ref_store)
    arrivals = ref_gen.gamma_trace(lam, cv, 120, seed=seed)
    theirs = ref_ds2.DS2Tuner(ref_pipe, ref_store, ds2_hardware(ref_pipe))
    ours = ds2.DS2Tuner(pipe, store, ds2_hardware(pipe))
    assert ours.mu == theirs.mu and ours.scale == theirs.scale
    assert stage_tuples(ours.initial_config(arrivals)) == \
        stage_tuples(theirs.initial_config(arrivals))
    assert ours.replicas == theirs.replicas
    assert ours._targets(lam * 2.5) == theirs._targets(lam * 2.5)
    assert ours.run_offline(arrivals) == theirs.run_offline(arrivals)
    assert ours.replicas == theirs.replicas


def test_run_ds2_matches_the_reference(image_pipeline):
    ref_pipe, ref_store = image_pipeline
    pipe, store = port_pipeline(ref_pipe), port_store(ref_store)
    bursty = ref_gen.gamma_trace(100, 4.0, 120, seed=3)
    theirs = ref_ds2.run_ds2(ref_ds2.DS2Tuner(
        ref_pipe, ref_store, ds2_hardware(ref_pipe)), ref_store, bursty, SLO)
    ours = ds2.run_ds2(ds2.DS2Tuner(pipe, store, ds2_hardware(pipe)),
                       store, bursty, SLO)
    assert np.array_equal(ours.sim.latency, theirs.sim.latency)
    assert ours.miss_rate == theirs.miss_rate
    assert ours.replica_timeline == theirs.replica_timeline
    assert np.array_equal(ours.cost_times, theirs.cost_times)
    assert np.array_equal(ours.cost_per_hr, theirs.cost_per_hr)


# ------------------------------------------------------------------- traces

@pytest.mark.parametrize("shape", ["big_spike", "dual_phase"])
@pytest.mark.parametrize("max_qps,segment_s,cv,seed", [
    (300.0, 30.0, 1.0, 0), (300.0, 30.0, 1.0, 5), (120.0, 10.0, 4.0, 2),
    (1e-12, 30.0, 1.0, 0)])
def test_autoscale_derived_traces_match_the_reference(shape, max_qps,
                                                      segment_s, cv, seed):
    ours = traces.autoscale_derived_trace(shape, max_qps, segment_s, cv, seed)
    theirs = ref_traces.autoscale_derived_trace(shape, max_qps, segment_s,
                                                cv, seed)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_autoscale_unknown_shape_raises():
    with pytest.raises(KeyError, match="ghost"):
        traces.autoscale_derived_trace("ghost")


@pytest.mark.parametrize("frac", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("arrivals", [
    np.arange(0, 100, 0.5), np.zeros(0),
    ref_gen.gamma_trace(100.0, 4.0, 60.0, seed=1)],
    ids=["grid", "empty", "bursty"])
def test_split_plan_serve_matches_the_reference(arrivals, frac):
    ours = traces.split_plan_serve(arrivals, frac)
    theirs = ref_traces.split_plan_serve(arrivals, frac)
    for got, exp in zip(ours, theirs):
        assert np.array_equal(got, exp)


# ---------------------------------------------------------------- generator

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_time_varying_generators_match_the_reference(seed):
    for fn, args in (
            ("time_varying_trace", (50.0, 1.0, 200.0, 4.0, 20.0, 10.0, 20.0)),
            ("rate_ramp_trace", (50.0, 200.0, 1.0, 20.0, 10.0, 20.0)),
            ("cv_ramp_trace", (100.0, 1.0, 4.0, 20.0, 10.0, 20.0))):
        ours = getattr(generator, fn)(*args, seed=seed)
        theirs = getattr(ref_gen, fn)(*args, seed=seed)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs), fn


@pytest.mark.parametrize("window_s,t_end", [(1.0, None), (30.0, None),
                                            (2.5, 80.0)])
def test_empirical_rate_matches_the_reference(window_s, t_end):
    arr = ref_gen.rate_ramp_trace(50, 200, 1.0, pre_s=20, ramp_s=10,
                                  post_s=20, seed=3)
    for a in (arr, np.zeros(0)):
        assert np.array_equal(generator.empirical_rate(a, window_s, t_end),
                              ref_gen.empirical_rate(a, window_s, t_end))
