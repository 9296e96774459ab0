"""The port's plan half against the JAX package's: traffic envelopes,
every branch of the per-stage queueing simulator, the engine and its
incremental sessions, and the Planner family. The simulator and the
planner are host numpy code in both packages, so every comparison is
exact (``np.array_equal``, ``==``), never a tolerance.

The pipelines and profiles are the reference's ``image_pipeline`` /
``social_pipeline`` fixtures (``tests/conftest.py``): each profile
table is copied into the port's ``ModelProfile``, and the port's
pipeline is built with the port's default hardware options, whose menu
also holds ``h100-1`` (a profile without it must plan exactly as the
reference does)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import envelope as ref_envelope
from repro.core.estimator import Estimator as RefEstimator
from repro.core.planner import (
    AnnealedPlanner as RefAnnealedPlanner,
    BeamPlanner as RefBeamPlanner,
    Planner as RefPlanner,
)
from repro.core.pipeline import (
    PipelineConfig as RefPipelineConfig,
    StageConfig as RefStageConfig,
)
from repro.faults.schedule import FaultSchedule, crash
from repro.sim.queueing import simulate_stage as ref_simulate_stage
from repro.workload.generator import gamma_trace as ref_gamma_trace
from repro.workload.slo_classes import (
    SLOClass as RefSLOClass,
    classed_trace as ref_classed_trace,
)
from repro_torch.core import envelope
from repro_torch.core.estimator import Estimator
from repro_torch.core.pipeline import (
    Edge,
    Pipeline,
    PipelineConfig,
    Stage,
    StageConfig,
    linear_pipeline,
)
from repro_torch.core.planner import AnnealedPlanner, BeamPlanner, Planner
from repro_torch.faults import FaultSchedule as PortFaultSchedule
from repro_torch.faults import crash as port_crash
from repro_torch.core.profiler import ModelProfile, ProfileStore
from repro_torch.sim import SimEngine, queueing
from repro_torch.sim.queueing import simulate_stage
from repro_torch.workload import SLOClass, classed_trace, gamma_trace

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ helpers

def port_store(ref_store) -> ProfileStore:
    """The reference profiles' tables and batch sizes, in the port's
    ``ModelProfile``."""
    store = ProfileStore()
    for mid in ref_store.model_ids():
        prof = ref_store.get(mid)
        store.add(ModelProfile(mid, dict(prof.table),
                               tuple(prof.batch_sizes)))
    return store


def port_pipeline(ref_pipe) -> Pipeline:
    """The same DAG with the port's default (whole-menu) stage options."""
    if ref_pipe.name == "image-processing":
        pipe = linear_pipeline(ref_pipe.name,
                               [st.model_id for st in
                                ref_pipe.stages.values()])
    else:
        pipe = Pipeline(ref_pipe.name,
                        {n: Stage(n, st.model_id)
                         for n, st in ref_pipe.stages.items()},
                        [Edge(e.src, e.dst, e.probability)
                         for e in ref_pipe.edges])
    assert list(pipe.stages) == list(ref_pipe.stages)
    assert all("h100-1" in st.hardware_options
               for st in pipe.stages.values())
    return pipe


@pytest.fixture(scope="module", params=["image", "social"])
def both(request, image_pipeline, social_pipeline):
    """(reference pipeline, reference store, port pipeline, port store)."""
    ref_pipe, ref_store = {"image": image_pipeline,
                           "social": social_pipeline}[request.param]
    return ref_pipe, ref_store, port_pipeline(ref_pipe), port_store(ref_store)


def to_ref(config) -> RefPipelineConfig:
    return RefPipelineConfig({s: RefStageConfig(c.hardware, c.batch_size,
                                                c.replicas, c.timeout_s,
                                                c.policy)
                              for s, c in config.stage_configs.items()})


def stage_tuples(config):
    return {s: (c.hardware, c.batch_size, c.replicas, c.timeout_s, c.policy)
            for s, c in config.stage_configs.items()}


def assert_same_result(ours, theirs):
    assert np.array_equal(ours.latency, theirs.latency)
    assert np.array_equal(ours.arrival, theirs.arrival)
    assert (ours.dropped is None) == (theirs.dropped is None)
    if ours.dropped is not None:
        assert np.array_equal(ours.dropped, theirs.dropped)
    assert set(ours.per_stage_batches) == set(theirs.per_stage_batches)
    for s, b in theirs.per_stage_batches.items():
        assert np.array_equal(ours.per_stage_batches[s], b)


def assert_same_stage(ours, theirs):
    for got, exp in zip(ours, theirs):
        assert got.dtype == exp.dtype
        assert np.array_equal(got, exp)


# ---------------------------------------------------------------- envelopes

@pytest.mark.parametrize("cv,seed", [(1.0, 0), (4.0, 1)])
def test_envelopes_match_the_reference(cv, seed):
    arr = ref_gamma_trace(100.0, cv, 30.0, seed=seed)
    assert np.array_equal(envelope.envelope_windows(0.037),
                          ref_envelope.envelope_windows(0.037))
    for w in (0.01, 0.25, 3.0):
        assert envelope.max_queries_in_window(arr, w) == \
            ref_envelope.max_queries_in_window(arr, w)
    ours = envelope.TrafficEnvelope.from_trace(arr, 0.05)
    theirs = ref_envelope.TrafficEnvelope.from_trace(arr, 0.05)
    assert np.array_equal(ours.windows, theirs.windows)
    assert np.array_equal(ours.max_counts, theirs.max_counts)
    assert np.array_equal(ours.rates, theirs.rates)
    assert ours.describe() == theirs.describe()
    # a burstier trace of the same windows exceeds the plan's envelope
    hot = ref_gamma_trace(150.0, cv * 2, 30.0, seed=seed + 7)
    ours_hot = envelope.TrafficEnvelope.from_trace(hot, 0.05)
    theirs_hot = ref_envelope.TrafficEnvelope.from_trace(hot, 0.05)
    assert ours.exceeded_by(ours_hot) == theirs.exceeded_by(theirs_hot)
    assert ours_hot.exceeded_by(ours) == theirs_hot.exceeded_by(theirs)
    # the streaming envelope over uneven chunks, one of them empty
    inc = envelope.IncrementalEnvelope(0.05)
    ref_inc = ref_envelope.IncrementalEnvelope(0.05)
    for chunk in np.split(arr, [5, 5, 400, 1700, arr.size - 3]):
        inc.extend(chunk)
        ref_inc.extend(chunk)
        assert inc.n == ref_inc.n
        snap, ref_snap = inc.snapshot(), ref_inc.snapshot()
        assert np.array_equal(snap.windows, ref_snap.windows)
        assert np.array_equal(snap.max_counts, ref_snap.max_counts)


# ----------------------------------------------------- per-stage simulator

def _lut(max_batch: int) -> np.ndarray:
    lut = np.zeros(max_batch + 1)
    lut[1:] = 0.004 + 0.0015 * np.arange(1, max_batch + 1)
    return lut


def _stage_inputs(n_s: float = 6.0, lam: float = 400.0, seed: int = 3):
    ready = np.sort(ref_gamma_trace(lam, 2.0, n_s, seed=seed))
    deadline = ready + np.random.default_rng(seed).uniform(0.02, 0.2,
                                                           ready.size)
    return ready, deadline


REPLICA_EVENTS = [(0.5, +1), (1.2, -1), (2.0, +1), (2.1, +1), (3.5, -1),
                  (4.0, -1)]


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("timeout_s", [0.0, 0.01])
@pytest.mark.parametrize("pool", ["static", "events"])
@pytest.mark.parametrize("policy", ["fifo", "edf", "slo-drop"])
def test_simulate_stage_matches_the_reference(policy, pool, timeout_s,
                                              batch):
    ready, deadline = _stage_inputs()
    events = REPLICA_EVENTS if pool == "events" else None
    args = (policy, ready, _lut(batch), batch, 2, events, timeout_s,
            deadline)
    assert_same_stage(simulate_stage(*args), ref_simulate_stage(*args))


@pytest.mark.parametrize("case", [
    "switched", "switched-events", "shed", "shed-events",
    "blocked-static", "blocked-timeout", "blocked-events",
])
def test_simulate_stage_special_paths_match_the_reference(case):
    """The policy-switch path, the slo-drop shed margin, and fills of at
    least ``_BLOCK_THRESHOLD`` queries, where the blocked vectorized
    FIFO kernel runs."""
    events = REPLICA_EVENTS if case.endswith("events") else None
    kw = {}
    if case.startswith("blocked"):
        ready, deadline = _stage_inputs(n_s=12.0, lam=3000.0, seed=5)
        assert ready.size >= queueing._BLOCK_THRESHOLD
        policy, batch, replicas = "fifo", 16, 3
        timeout_s = 0.002 if case == "blocked-timeout" else 0.0
        deadline = None
    else:
        ready, deadline = _stage_inputs()
        policy, batch, replicas, timeout_s = "fifo", 8, 2, 0.005
        if case.startswith("switched"):
            kw["policy_events"] = [(1.0, "edf"), (2.5, "slo-drop"),
                                   (4.0, "fifo")]
        else:
            policy = "slo-drop"
            kw["shed_events"] = [(1.0, 0.01), (2.0, -np.inf), (3.0, 0.05)]
    args = (policy, ready, _lut(batch), batch, replicas, events, timeout_s,
            deadline)
    ours = simulate_stage(*args, **kw)
    theirs = ref_simulate_stage(*args, **kw)
    assert_same_stage(ours, theirs)
    if case.startswith("shed"):
        assert ours[2].any()                  # the margin shed queries


def test_the_port_takes_numpy_or_torch_and_faults(image_pipeline):
    """The port fills with numpy or its torch backend ("jax" raises, and
    "torch" with no device on a host without a GPU raises), and a fault
    schedule runs the fault-aware loop, equal to the reference's; an
    empty schedule is the no-fault path."""
    ready, deadline = _stage_inputs(n_s=1.0)
    with pytest.raises(ValueError, match="backend"):
        simulate_stage("fifo", ready, _lut(4), 4, 1, backend="jax")
    assert_same_stage(
        simulate_stage("fifo", ready, _lut(4), 4, 1, backend="torch",
                       device="cpu"),
        ref_simulate_stage("fifo", ready, _lut(4), 4, 1))
    spec = PortFaultSchedule([port_crash("s", 0.5)]).stage("s")
    ours = simulate_stage("fifo", ready, _lut(4), 4, 1, fault_spec=spec)
    assert_same_stage(ours, ref_simulate_stage(
        "fifo", ready, _lut(4), 4, 1,
        fault_spec=FaultSchedule([crash("s", 0.5)]).stage("s")))
    # one replica crashed at 0.5 s and none replaced it: the rest starve
    assert (ours[0][ready > 0.5] == 1e18).any()
    # an empty spec is the no-fault path
    assert_same_stage(
        simulate_stage("fifo", ready, _lut(4), 4, 1,
                       fault_spec=PortFaultSchedule([]).stage("s")),
        ref_simulate_stage("fifo", ready, _lut(4), 4, 1))
    ref_pipe, ref_store = image_pipeline
    pipe, store = port_pipeline(ref_pipe), port_store(ref_store)
    est = Estimator(pipe, store)
    with pytest.raises(ValueError, match="backend"):
        est.session(ready, backend="jax")
    sess = SimEngine(pipe, store).session(ready, backend="torch",
                                          device="cpu")
    assert (sess.backend, sess.device) == ("torch", torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            SimEngine(pipe, store).session(ready, backend="torch")
        with pytest.raises(RuntimeError, match="GPU"):
            simulate_stage("fifo", ready, _lut(4), 4, 1, backend="torch")
    config = PipelineConfig({s: StageConfig("cpu-1", 4, 2)
                             for s in pipe.stages})
    first = next(iter(pipe.stages))
    assert_same_result(
        est.engine.simulate(config, ready, fault_schedules=PortFaultSchedule(
            [port_crash(first, 0.5)])),
        RefEstimator(ref_pipe, ref_store).engine.simulate(
            to_ref(config), ready,
            fault_schedules=FaultSchedule([crash(first, 0.5)])))
    with pytest.raises(ValueError, match="backend"):
        Planner(pipe, store, backend="jax")
    assert Planner(pipe, store, backend="torch", device="cpu").backend == \
        "torch"


# ------------------------------------------------------ engine and sessions

def _configs(pipe, policy="fifo", timeout_s=0.0):
    stages = list(pipe.stages)
    base = {s: StageConfig("tpu-v5e-1", 8, 2, timeout_s, policy)
            for s in stages}
    base[stages[0]] = StageConfig("cpu-1", 4, 6, timeout_s, policy)
    first = PipelineConfig(base)
    second = first.copy()
    second[stages[-1]].batch_size = 16
    third = first.copy()
    third.stage_configs[stages[0]] = StageConfig("tpu-v5e-4", 2, 1,
                                                 timeout_s, policy)
    return [first, second, third]


@pytest.mark.parametrize("variant", [
    "fifo", "timeout", "schedules", "edf-slo", "slo-drop-classes"])
def test_estimator_matches_the_reference(both, sample_trace, variant):
    ref_pipe, ref_store, pipe, store = both
    policy = {"edf-slo": "edf", "slo-drop-classes": "slo-drop"}.get(
        variant, "fifo")
    timeout_s = 0.004 if variant == "timeout" else 0.0
    kw = {}
    if variant == "schedules":
        kw["replica_schedules"] = {s: [(5.0, +1), (20.0, +2), (30.0, -1)]
                                   for s in pipe.stages}
    if variant == "edf-slo":
        kw["slo_s"] = 0.3
    if variant == "slo-drop-classes":
        mix = classed_trace([SLOClass("tight", 60.0, 1.0, 0.15),
                             SLOClass("loose", 60.0, 2.0, 1.0)], 30.0, seed=2)
        ref_mix = ref_classed_trace([RefSLOClass("tight", 60.0, 1.0, 0.15),
                                     RefSLOClass("loose", 60.0, 2.0, 1.0)],
                                    30.0, seed=2)
        assert np.array_equal(mix.arrivals, ref_mix.arrivals)
        assert np.array_equal(mix.class_ids, ref_mix.class_ids)
        arrivals = mix.arrivals
        kw.update(slo_s=mix.slo_per_query, class_ids=mix.class_ids,
                  class_names=mix.class_names)
    else:
        arrivals = sample_trace
    est, ref_est = Estimator(pipe, store), RefEstimator(ref_pipe, ref_store)
    dropped = 0
    for config in _configs(pipe, policy, timeout_s):
        ours = est.simulate(config, arrivals, **kw)
        theirs = ref_est.simulate(to_ref(config), arrivals, **kw)
        assert_same_result(ours, theirs)
        if "class_ids" in kw:
            # NaN percentiles where a class has shed queries: equal as NaN
            np.testing.assert_equal(ours.per_class(), theirs.per_class())
        assert est.service_time(config) == \
            ref_est.service_time(to_ref(config))
        dropped += ours.num_dropped
    assert (dropped > 0) == (variant == "slo-drop-classes")


def test_interleaved_sessions_match_the_reference(both, bursty_trace):
    """One TraceSession per package over the same sequence of calls,
    alternating configurations that share cones: the same latencies,
    percentiles and cache statistics at every step."""
    ref_pipe, ref_store, pipe, store = both
    sess = Estimator(pipe, store).session(bursty_trace)
    ref_sess = RefEstimator(ref_pipe, ref_store).session(bursty_trace)
    first, second, third = _configs(pipe)
    # configurations that differ from `first` in one knob of one stage:
    # a cone key that dropped the knob would replay `first`'s entry
    last = list(pipe.stages)[-1]
    knobs = []
    for knob, value in (("replicas", 3), ("timeout_s", 0.002),
                        ("policy", "edf")):
        cfg = first.copy()
        setattr(cfg[last], knob, value)
        knobs.append(cfg)
    sched = {next(iter(pipe.stages)): [(10.0, +1), (40.0, -1)]}
    calls = [("sim", first, None), *(("sim", c, None) for c in knobs),
             ("sim", second, None),
             ("pct", first, None), ("sim", third, sched),
             ("sim", first, None), ("many", [second, third, first], None),
             ("pct", third, sched), ("delta", second, None),
             ("states", third, sched)]
    for kind, cfg, sch in calls:
        if kind == "sim":
            assert_same_result(sess.simulate(cfg, sch),
                               ref_sess.simulate(to_ref(cfg), sch))
        elif kind == "pct":
            assert sess.percentile(cfg, 99.0, sch) == \
                ref_sess.percentile(to_ref(cfg), 99.0, sch)
        elif kind == "many":
            for o, t in zip(sess.simulate_many(cfg),
                            ref_sess.simulate_many([to_ref(c)
                                                    for c in cfg])):
                assert_same_result(o, t)
            assert sess.percentile_many(cfg, 95.0) == \
                ref_sess.percentile_many([to_ref(c) for c in cfg], 95.0)
        elif kind == "delta":
            assert_same_result(sess.simulate_delta(cfg),
                               ref_sess.simulate_delta(to_ref(cfg)))
        else:
            ours = sess.stage_states(cfg, sch)
            theirs = ref_sess.stage_states(to_ref(cfg), sch)
            assert list(ours) == list(theirs)
            for s, st in theirs.items():
                for f in ("visited", "ready", "completion"):
                    assert np.array_equal(getattr(ours[s], f),
                                          getattr(st, f))
        assert sess.stats == ref_sess.stats


# ------------------------------------------------------------------ planner

def _plan(kind, pipe, store, arrivals, slo, ref=False):
    cls = {"greedy": (Planner, RefPlanner),
           "beam": (BeamPlanner, RefBeamPlanner),
           "annealed": (AnnealedPlanner, RefAnnealedPlanner)}[kind][ref]
    planner = cls(pipe, store)
    if kind == "annealed":
        return planner.plan(arrivals, slo, steps=60, seed=3)
    return planner.plan(arrivals, slo)


def assert_same_plan(ours, theirs):
    assert ours.feasible == theirs.feasible
    assert ours.cost_per_hr == theirs.cost_per_hr
    assert ours.estimated_p99 == theirs.estimated_p99
    assert (ours.iterations, ours.simulations) == \
        (theirs.iterations, theirs.simulations)
    if theirs.feasible:
        assert stage_tuples(ours.config) == stage_tuples(theirs.config)
        assert ours.config.cost_per_hr() == theirs.config.cost_per_hr()
    assert ours.describe() == theirs.describe()


@pytest.mark.parametrize("trace", ["sample", "bursty"])
@pytest.mark.parametrize("kind", ["greedy", "beam", "annealed"])
def test_planners_match_the_reference(both, kind, trace, sample_trace,
                                      bursty_trace):
    ref_pipe, ref_store, pipe, store = both
    arrivals = {"sample": sample_trace, "bursty": bursty_trace}[trace]
    ours = _plan(kind, pipe, store, arrivals, 0.3)
    theirs = _plan(kind, ref_pipe, ref_store, arrivals, 0.3, ref=True)
    assert theirs.feasible
    assert_same_plan(ours, theirs)
    assert all(c.hardware != "h100-1"
               for c in ours.config.stage_configs.values())


@pytest.mark.parametrize("kind", ["greedy", "beam", "annealed"])
def test_an_infeasible_slo_is_infeasible(both, kind, sample_trace):
    ref_pipe, ref_store, pipe, store = both
    ours = _plan(kind, pipe, store, sample_trace, 1e-4)
    theirs = _plan(kind, ref_pipe, ref_store, sample_trace, 1e-4, ref=True)
    assert not ours.feasible and ours.config is None
    assert_same_plan(ours, theirs)


def test_plan_classed_matches_the_reference(both):
    ref_pipe, ref_store, pipe, store = both
    classes = [("interactive", 60.0, 1.0, 0.2), ("batch", 120.0, 2.0, 1.0)]
    mix = classed_trace([SLOClass(*c) for c in classes], 40.0, seed=0)
    ref_mix = ref_classed_trace([RefSLOClass(*c) for c in classes], 40.0,
                                seed=0)
    ours = Planner(pipe, store).plan_classed(mix)
    theirs = RefPlanner(ref_pipe, ref_store).plan_classed(ref_mix)
    assert theirs.feasible
    assert_same_plan(ours, theirs)
    assert ours.per_class_p == theirs.per_class_p


def test_a_plan_on_the_card_has_a_finite_cost():
    """A measured h100-1 profile plans to a finite cost, and the
    Estimator's p99 of the plan is what the planner reports."""
    table = {("h100-1", b): 0.02 + 0.002 * b for b in (1, 2, 4, 8, 16)}
    store = ProfileStore()
    for mid in ("a", "b"):
        store.add(ModelProfile(mid, dict(table), (1, 2, 4, 8, 16)))
    pipe = linear_pipeline("cascade", ["a", "b"],
                           {"a": ["h100-1"], "b": ["h100-1"]})
    arrivals = gamma_trace(30.0, 1.0, 20, seed=0)
    plan = Planner(pipe, store).plan(arrivals, 0.25)
    assert plan.feasible
    assert np.isfinite(plan.cost_per_hr) and plan.cost_per_hr > 0
    assert {c.hardware for c in plan.config.stage_configs.values()} == \
        {"h100-1"}
    assert Estimator(pipe, store).simulate(plan.config, arrivals).p99 == \
        plan.estimated_p99


# ----------------------------------------------------------------- analyzer

def test_the_analyzer_finds_nothing_in_the_copies(tmp_path):
    """KEY01 (cache-key completeness) and DET01 (determinism) locate
    their files by ``repro/...`` suffixes, so the port's copies are laid
    out under a ``repro`` tree and scanned there. The one accepted
    finding is the reference's own (``analysis_baseline.txt``): the
    measured profiler reads the wall clock by design."""
    src = ROOT / "src" / "repro_torch"
    copies = ["core/pipeline.py", "core/policy.py", "core/envelope.py",
              "core/estimator.py", "core/planner.py", "core/profiler.py",
              "core/hardware.py", "configs/pipelines.py", "sim/engine.py",
              "sim/queueing.py", "sim/result.py", "sim/torch_backend.py",
              "workload/slo_classes.py", "workload/generator.py",
              "workload/traces.py", "baselines/coarse_grained.py",
              "baselines/ds2.py"]
    for rel in copies:
        dst = tmp_path / "repro" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src / rel, dst)
    accepted = [line for line in
                (ROOT / "analysis_baseline.txt").read_text().splitlines()
                if line.startswith("DET01\trepro/core/profiler.py\t")]
    assert len(accepted) == 1
    baseline = tmp_path / "baseline.txt"
    baseline.write_text(accepted[0] + "\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "--root", str(tmp_path),
         "--rules", "KEY01,DET01", "--baseline", str(baseline), "--json"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    report = json.loads(proc.stdout)
    assert report["files_scanned"] == len(copies)
    assert report["findings"] == [], report["findings"]
    assert {(f["path"], f["scope"]) for f in report["suppressed"]} == \
        {("repro/core/profiler.py", "profile_model_measured")}
    assert report["unused_baseline"] == []
    assert proc.returncode == 0, proc.stderr
