"""The port's tune half against the JAX package's: control events and
the cost timeline (``control.py``), the Tuner family (``core/tuner.py``)
and the closed-loop co-simulation (``sim/control.py``). All of them are
host numpy code in both packages, so every comparison is exact
(``np.array_equal``, ``==``), never a tolerance.

The pipelines and profiles are the reference's ``image_pipeline`` /
``social_pipeline`` fixtures, copied into the port's types as
``tests/test_torch_plan.py`` does; every input is built from a seed with
numpy and fed to both packages."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.control import (
    ControlEvent as RefControlEvent,
    ScheduleController as RefScheduleController,
    fold_control_event as ref_fold_control_event,
    integrate_cost as ref_integrate_cost,
    mean_cost_per_hr as ref_mean_cost_per_hr,
    replica_cost_timeline as ref_replica_cost_timeline,
)
from repro.core.envelope import TrafficEnvelope as RefTrafficEnvelope
from repro.faults import FaultSchedule as RefFaultSchedule
from repro.faults import crash as ref_crash
from repro.core.estimator import Estimator as RefEstimator
from repro.core.planner import Planner as RefPlanner
from repro.core.tuner import (
    ClosedLoopTuner as RefClosedLoopTuner,
    OpenLoopTunerController as RefOpenLoopTunerController,
    Tuner as RefTuner,
    TunerPlanInfo as RefTunerPlanInfo,
    run_tuner_offline as ref_run_tuner_offline,
)
from repro.sim.control import ControlLoopSession as RefControlLoopSession
from repro.sim.result import (
    EpochTelemetry as RefEpochTelemetry,
    StageTelemetry as RefStageTelemetry,
)
from repro.workload.generator import gamma_trace as ref_gamma_trace
from repro_torch.control import (
    ControlEvent,
    ScheduleController,
    fold_control_event,
    integrate_cost,
    mean_cost_per_hr,
    replica_cost_timeline,
)
from repro_torch.core.envelope import TrafficEnvelope
from repro_torch.core.estimator import Estimator
from repro_torch.core.pipeline import PipelineConfig, StageConfig
from repro_torch.faults import FaultSchedule, crash
from repro_torch.core.tuner import (
    ClosedLoopTuner,
    OpenLoopTunerController,
    Tuner,
    TunerPlanInfo,
    run_tuner_offline,
)
from repro_torch.sim import ControlLoopSession
from repro_torch.sim.result import EpochTelemetry, StageTelemetry
from repro_torch.workload import gamma_trace
from test_torch_plan import port_pipeline, port_store

SLO = 0.15
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=["image", "social"])
def planned(request, image_pipeline, social_pipeline):
    """Both packages' pipeline, profiles, planned configuration, Tuner
    plan info and a spike trace: (reference tuple, port tuple, trace)."""
    ref_pipe, ref_store = {"image": image_pipeline,
                           "social": social_pipeline}[request.param]
    pipe, store = port_pipeline(ref_pipe), port_store(ref_store)
    sample = ref_gamma_trace(150.0, 1.0, 60.0, seed=0)
    plan = RefPlanner(ref_pipe, ref_store).plan(sample, SLO)
    assert plan.feasible
    ref_config = plan.config
    config = PipelineConfig({
        s: StageConfig(c.hardware, c.batch_size, c.replicas, c.timeout_s,
                       c.policy)
        for s, c in ref_config.stage_configs.items()})
    ref_info = RefTunerPlanInfo.from_plan(
        ref_pipe, ref_config, ref_store, sample,
        RefEstimator(ref_pipe, ref_store).service_time(ref_config))
    info = TunerPlanInfo.from_plan(pipe, config, store, sample,
                                   Estimator(pipe, store).service_time(config))
    spike = np.concatenate([
        sample, 60.0 + ref_gamma_trace(500, 0.5, 12, seed=11),
        72.0 + ref_gamma_trace(150, 1.0, 40, seed=12)])
    return ((ref_pipe, ref_store, ref_config, ref_info),
            (pipe, store, config, info), spike)


def _events(evs):
    return [e.as_record() for e in evs]


def assert_same_telemetry(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "stages":
                assert {s: dataclasses.asdict(t) for s, t in x.items()} == \
                    {s: dataclasses.asdict(t) for s, t in y.items()}
            elif f.name == "observed_envelope":
                assert np.array_equal(x.windows, y.windows)
                assert np.array_equal(x.max_counts, y.max_counts)
            elif f.name == "ingress_prefix":
                assert np.array_equal(x, y)
            else:
                assert x == y or (np.isnan(x) and np.isnan(y)), f.name


# ------------------------------------------------------ events and cost

def _random_events(rng, stages, n, ctor):
    """(decision time, event) pairs from one seeded stream, every kind."""
    out = []
    t = 0.0
    for _ in range(n):
        t += float(rng.uniform(0.0, 3.0))
        stage = stages[int(rng.integers(len(stages)))]
        kind = ("up", "down", "shed", "policy")[int(rng.integers(4))]
        lag = float(rng.choice([0.0, 5.0]))
        if kind == "up":
            ev = ctor(t, t + lag, stage, "up", int(rng.integers(1, 4)))
        elif kind == "down":
            ev = ctor(t, t, stage, "down", -int(rng.integers(1, 3)))
        elif kind == "shed":
            ev = ctor(t, t, stage, "shed", float(rng.uniform(0, 0.05)))
        else:
            ev = ctor(t, t, stage, "policy", 0.0,
                      policy=("fifo", "edf", "slo-drop")[
                          int(rng.integers(3))])
        out.append((t, ev))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_folded_schedules_and_cost_match_the_reference(planned, seed):
    (ref_pipe, _, ref_config, _), (pipe, _, config, _), _ = planned
    stages = list(pipe.stages)
    ours = _random_events(np.random.default_rng(seed), stages, 40,
                          ControlEvent)
    theirs = _random_events(np.random.default_rng(seed), stages, 40,
                            RefControlEvent)
    streams, ref_streams = ({}, {}, {}), ({}, {}, {})
    for (t, ev), (_, rev) in zip(ours, theirs):
        fold_control_event(ev, pipe.stages, t, *streams)
        ref_fold_control_event(rev, ref_pipe.stages, t, *ref_streams)
    assert streams == ref_streams
    t_end = ours[-1][0] + 1.0
    times, costs, timeline = replica_cost_timeline(pipe, config, streams[0],
                                                   t_end)
    rt, rc, rtl = ref_replica_cost_timeline(ref_pipe, ref_config,
                                            ref_streams[0], t_end)
    assert np.array_equal(times, rt) and np.array_equal(costs, rc)
    assert timeline == rtl
    assert integrate_cost(times, costs, t_end) == \
        ref_integrate_cost(rt, rc, t_end)
    assert mean_cost_per_hr(times, costs, t_end) == \
        ref_mean_cost_per_hr(rt, rc, t_end)
    assert integrate_cost(np.zeros(0), np.zeros(0), 5.0) == 0.0


def test_fold_refuses_what_the_reference_refuses(planned):
    (ref_pipe, *_), (pipe, *_), _ = planned
    stage = next(iter(pipe.stages))
    bad = [(stage, "up", 1.0, 0.5, None),        # acausal
           ("nope", "up", 1.0, 1.0, None),       # unknown stage
           (stage, "grow", 1.0, 1.0, None),      # unknown kind
           (stage, "policy", 1.0, 1.0, None)]    # no policy name
    for s, kind, now, t_eff, pol in bad:
        for ctor, fold, stages in ((ControlEvent, fold_control_event,
                                    pipe.stages),
                                   (RefControlEvent, ref_fold_control_event,
                                    ref_pipe.stages)):
            with pytest.raises(ValueError):
                fold(ctor(now, t_eff, s, kind, 1.0, pol), stages, now,
                     {}, {}, {})


# ------------------------------------------------------------- the tuner

def test_plan_info_matches_the_reference(planned):
    (*_, ref_info), (*_, info), _ = planned
    for f in ("mu", "rho", "scale_factors", "planned_replicas",
              "service_time_s"):
        assert getattr(info, f) == getattr(ref_info, f), f
    assert np.array_equal(info.planned_envelope.windows,
                          ref_info.planned_envelope.windows)
    assert np.array_equal(info.planned_envelope.max_counts,
                          ref_info.planned_envelope.max_counts)


def test_offline_schedule_matches_the_reference(planned):
    (*_, ref_info), (*_, info), spike = planned
    tuner, ref_tuner = Tuner(info), RefTuner(ref_info)
    assert run_tuner_offline(tuner, spike) == \
        ref_run_tuner_offline(ref_tuner, spike)
    assert tuner.events == ref_tuner.events and tuner.events


def _telemetry_pair(rng, epoch, arr, stages, current, service):
    """The same synthetic EpochTelemetry in both packages' types: random
    queue depths, misses and ``alive`` counts, some below the target."""
    t0, t1 = float(epoch - 1), float(epoch)
    prefix = arr[arr <= t1]
    rows = {}
    for s in stages:
        target = current[s]
        rows[s] = dict(stage=s, arrived=int(rng.integers(0, 200)),
                       completed=int(rng.integers(0, 200)),
                       dropped=int(rng.integers(0, 5)),
                       queue_depth=int(rng.choice([0, 0, 5, 400, 3000])),
                       in_flight=int(rng.integers(0, 8)), replicas=target,
                       alive=int(rng.choice([target, target,
                                             max(target - 1, 0), -1])))
    n_win = int(((arr > t0) & (arr <= t1)).sum())
    common = dict(epoch=epoch, t_start=t0, t_end=t1, ingress=n_win,
                  ingress_prefix=prefix, completed=max(n_win, 1),
                  missed=int(rng.choice([0, 0, 0, 30])), overdue=0,
                  drops=0, p99_s=float("nan"))
    ours = EpochTelemetry(
        observed_envelope=TrafficEnvelope.from_trace(prefix, service),
        stages={s: StageTelemetry(**r) for s, r in rows.items()}, **common)
    theirs = RefEpochTelemetry(
        observed_envelope=RefTrafficEnvelope.from_trace(prefix, service),
        stages={s: RefStageTelemetry(**r) for s, r in rows.items()},
        **common)
    return ours, theirs


@pytest.mark.parametrize("kwargs", [
    {},
    {"max_replicas": 3},
    {"shed_stages": "all", "shed_patience": 1},
    {"failure_recovery": False, "max_replicas": 2},
], ids=["default", "max_replicas", "shed_stages", "no_recovery"])
@pytest.mark.parametrize("seed", [0, 7])
def test_closed_loop_tuner_events_match_the_reference(planned, kwargs,
                                                      seed):
    """One telemetry sequence, fed to both ClosedLoopTuners epoch by
    epoch, gives the same events, the same counts and the same event
    log."""
    (*_, ref_info), (pipe, *_, info), spike = planned
    stages = list(pipe.stages)
    kw = dict(kwargs)
    if kw.get("shed_stages") == "all":
        kw["shed_stages"] = tuple(stages)
    tuner, ref_tuner = ClosedLoopTuner(info, **kw), \
        RefClosedLoopTuner(ref_info, **kw)
    rng = np.random.default_rng(seed)
    kinds = set()
    for epoch in range(1, 113):
        ours, theirs = _telemetry_pair(rng, epoch, spike, stages,
                                       tuner.current, info.service_time_s)
        evs, ref_evs = tuner.step(ours), ref_tuner.step(theirs)
        assert _events(evs) == _events(ref_evs), epoch
        assert tuner.current == ref_tuner.current
        kinds.update(e.kind for e in evs)
    assert tuner.events == ref_tuner.events
    assert "up" in kinds
    if "max_replicas" in kw:
        # the cap bounds scale-ups, never the planned fleet
        assert all(k <= max(kw["max_replicas"], info.planned_replicas[s])
                   for s, k in tuner.current.items())
    if "shed_stages" in kw:
        assert "shed" in kinds


# ------------------------------------------------------- co-simulation

def _controllers(kind, info, ref_info, stages):
    if kind == "closed":
        return ClosedLoopTuner(info), RefClosedLoopTuner(ref_info)
    if kind == "open":
        return (OpenLoopTunerController(Tuner(info)),
                RefOpenLoopTunerController(RefTuner(ref_info)))
    plan = [(3.0, 8.0, stages[0], "up", 2), (20.0, 20.0, stages[-1], "up", 1),
            (40.0, 40.0, stages[0], "down", -1)]
    return (ScheduleController([ControlEvent(*e) for e in plan]),
            RefScheduleController([RefControlEvent(*e) for e in plan]))


@pytest.mark.parametrize("kind", ["closed", "open", "schedule"])
def test_control_loop_session_matches_the_reference(planned, kind):
    (ref_pipe, ref_store, ref_config, ref_info), \
        (pipe, store, config, info), spike = planned
    ours_ctl, ref_ctl = _controllers(kind, info, ref_info, list(pipe.stages))
    ours = ControlLoopSession(pipe, store, config, SLO).run(spike, ours_ctl)
    theirs = RefControlLoopSession(ref_pipe, ref_store, ref_config,
                                   SLO).run(spike, ref_ctl)
    assert np.array_equal(ours.sim.latency, theirs.sim.latency)
    assert np.array_equal(ours.sim.arrival, theirs.sim.arrival)
    assert (ours.sim.dropped is None) == (theirs.sim.dropped is None)
    if ours.sim.dropped is not None:
        assert np.array_equal(ours.sim.dropped, theirs.sim.dropped)
    assert _events(ours.events) == _events(theirs.events)
    assert ours.events, "the controller issued no event on the spike"
    assert ours.replica_schedules == theirs.replica_schedules
    assert ours.shed_schedules == theirs.shed_schedules
    assert ours.policy_schedules == theirs.policy_schedules
    assert ours.replica_timeline == theirs.replica_timeline
    assert np.array_equal(ours.cost_times, theirs.cost_times)
    assert np.array_equal(ours.cost_per_hr, theirs.cost_per_hr)
    assert ours.miss_rate == theirs.miss_rate
    assert ours.total_cost() == theirs.total_cost()
    assert_same_telemetry(ours.telemetry, theirs.telemetry)


def test_control_loop_session_refuses_faults_and_unsorted_traces(planned):
    """An unsorted trace still raises. A fault schedule, which the port
    refused before it had fault injection, now runs as the reference's
    does (``tests/test_torch_faults.py`` compares it in full)."""
    (ref_pipe, ref_store, ref_config, ref_info), \
        (pipe, store, config, info), spike = planned
    sess = ControlLoopSession(pipe, store, config, SLO)
    stage = max(config.stage_configs, key=lambda s: config[s].replicas)
    ours = sess.run(spike, ClosedLoopTuner(info),
                    faults=FaultSchedule([crash(stage, 65.5)], seed=4))
    theirs = RefControlLoopSession(ref_pipe, ref_store, ref_config,
                                   SLO).run(
        spike, RefClosedLoopTuner(ref_info),
        faults=RefFaultSchedule([ref_crash(stage, 65.5)], seed=4))
    assert np.array_equal(ours.sim.latency, theirs.sim.latency)
    assert _events(ours.events) == _events(theirs.events)
    assert_same_telemetry(ours.telemetry, theirs.telemetry)
    with pytest.raises(ValueError, match="sorted"):
        sess.run(spike[::-1], ClosedLoopTuner(info))


def test_the_spike_generator_matches_the_reference():
    """The example's spike (step 5), built from the port's generator."""
    def spike(gen):
        return np.concatenate([gen(30, 1.0, 8, seed=3),
                               8.0 + gen(90, 0.7, 5, seed=4),
                               13.0 + gen(30, 1.0, 17, seed=5)])
    assert np.array_equal(spike(gamma_trace), spike(ref_gamma_trace))


# ----------------------------------------------------------------- analyzer

def _analyze(tmp_path, copies, rules, edit=None):
    """Lay the port's ``copies`` out under ``tmp_path/repro/`` (the rules
    match files by ``repro/...`` paths), optionally ``edit`` one of them,
    and run the repository's analyzer with ``rules`` there."""
    src = ROOT / "src" / "repro_torch"
    for rel in copies:
        dst = tmp_path / "repro" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src / rel, dst)
    if edit is not None:
        rel, old, new = edit
        path = tmp_path / "repro" / rel
        text = path.read_text()
        assert old in text
        path.write_text(text.replace(old, new))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "--root", str(tmp_path),
         "--rules", rules, "--baseline", str(tmp_path / "none"), "--json"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    report = json.loads(proc.stdout)
    assert report["files_scanned"] == len(copies)
    return report["findings"], proc.returncode


SERVING = ["serving/executor.py", "serving/loop.py", "serving/stage.py"]


def test_lock01_finds_nothing_in_the_serving_copies(tmp_path):
    """LOCK01 (lock discipline; scope ``repro/serving/``) over the port's
    threaded executor, its live loop and the stage's slot pool."""
    findings, rc = _analyze(tmp_path, SERVING, "LOCK01")
    assert findings == [], findings
    assert rc == 0


@pytest.mark.parametrize("rel,old,new", [
    ("serving/executor.py",
     "        with st.cond:\n            return st.target",
     "        if True:\n            return st.target"),
    ("serving/stage.py",
     "            i = min(self._free)\n            self._free.remove(i)",
     "            i = min(self._free)\n        self._free.remove(i)"),
], ids=["executor", "stage"])
def test_lock01_sees_the_serving_copies(tmp_path, rel, old, new):
    """The same run finds an unguarded access put into a copy: the rule
    reads the copies' annotations, not nothing."""
    findings, rc = _analyze(tmp_path, SERVING, "LOCK01", (rel, old, new))
    assert [f["path"] for f in findings] == [f"repro/{rel}"], findings
    assert rc != 0


def test_key01_det01_find_nothing_in_the_tune_copies(tmp_path):
    """KEY01 (cache-key completeness) and DET01 (determinism) over the
    tune half's copies, as ``tests/test_torch_plan.py`` runs them over
    the plan half's."""
    findings, rc = _analyze(
        tmp_path, ["control.py", "core/tuner.py", "sim/control.py"],
        "KEY01,DET01")
    assert findings == [], findings
    assert rc == 0
