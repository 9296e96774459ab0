"""The port's fault injection against the JAX package's: the fault
vocabulary and its keys (``faults/schedule.py``), the fault-aware stage
simulation (``faults/simstage.py``), the engine and its sessions with
fault schedules (``sim/engine.py``), the co-simulated twin with faults
(``sim/control.py``) and the live-cluster simulation
(``serving/cluster.py``). All of them are host numpy code in both
packages, so every comparison is exact (``np.array_equal``, ``==``).

The pipelines and profiles are the reference's ``image_pipeline`` /
``social_pipeline`` fixtures, copied into the port's types as
``tests/test_torch_plan.py`` does; every input is built from a seed with
numpy and fed to both packages."""

import dataclasses

import numpy as np
import pytest

from repro.core.tuner import Tuner as RefTuner
from repro.core.tuner import run_tuner_offline as ref_run_tuner_offline
from repro.faults import (
    FaultSchedule as RefFaultSchedule,
    RecoveryPolicy as RefRecoveryPolicy,
    crash as ref_crash,
    straggle as ref_straggle,
    transient as ref_transient,
)
from repro.faults.simstage import simulate_stage_faults as ref_stage_faults
from repro.serving.cluster import LiveClusterSim as RefLiveClusterSim
from repro.serving.frontends import FRONTENDS as REF_FRONTENDS
from repro.sim import ControlLoopSession as RefControlLoopSession
from repro.sim import SimEngine as RefSimEngine
from repro.core.tuner import ClosedLoopTuner as RefClosedLoopTuner
from repro_torch.core.tuner import ClosedLoopTuner, Tuner, run_tuner_offline
from repro_torch.faults import (
    Fault,
    FaultSchedule,
    RecoveryPolicy,
    crash,
    straggle,
    transient,
)
from repro_torch.faults.simstage import simulate_stage_faults
from repro_torch.serving import FRONTENDS, LiveClusterSim
from repro_torch.sim import ControlLoopSession, SimEngine
from test_torch_control import (  # noqa: F401 — `planned` is a fixture
    SLO,
    _analyze,
    _events,
    assert_same_telemetry,
    planned,
)
from test_torch_plan import (
    _lut,
    _stage_inputs,
    assert_same_result,
    assert_same_stage,
    port_pipeline,
    port_store,
    to_ref,
)

# fault scenarios over one stage "s": (events, seed, recovery kwargs);
# each event is (kind, t0, t1, value) and built in both packages
SCENARIOS = {
    "crash": ([("crash", 0.7, 0.7, 1), ("crash", 2.5, 2.5, 1)], 0, {}),
    "crash-all": ([("crash", 1.0, 1.0, 5)], 1, {}),
    "straggle": ([("straggle", 0.5, 2.0, 3.0), ("straggle", 1.5, 4.0, 2.0)],
                 2, {}),
    "transient": ([("error", 0.0, 3.0, 0.4)], 3,
                  dict(max_attempts=4, backoff_s=0.01, backoff_mult=2.0)),
    "hedged": ([("error", 0.5, 4.0, 0.5), ("crash", 2.0, 2.0, 1)], 4,
               dict(max_attempts=5, backoff_s=0.005, backoff_mult=1.5,
                    hedge_slack_s=0.08)),
    "no-recovery": ([("error", 0.0, 5.0, 0.3), ("crash", 1.0, 1.0, 1)], 5,
                    dict(enabled=False)),
    "mixed": ([("crash", 0.4, 0.4, 1), ("straggle", 1.0, 3.0, 4.0),
               ("error", 2.0, 5.0, 0.2)], 6,
              dict(max_attempts=3, backoff_s=0.02, hedge_slack_s=0.05)),
}

MAKE = {"crash": (crash, ref_crash), "straggle": (straggle, ref_straggle),
        "error": (transient, ref_transient)}


def _fault(pkg: int, stage: str, kind: str, t0: float, t1: float, value):
    make = MAKE[kind][pkg]
    if kind == "crash":
        return make(stage, t0, int(value))
    return make(stage, t0, t1, value)


def schedules(name: str, stages):
    """(port FaultSchedule, reference FaultSchedule) of scenario `name`,
    its events put on every stage of `stages`."""
    events, seed, rec = SCENARIOS[name]
    out = []
    for pkg, (fs, rp) in enumerate([(FaultSchedule, RecoveryPolicy),
                                    (RefFaultSchedule, RefRecoveryPolicy)]):
        out.append(fs([_fault(pkg, s, *ev) for s in stages for ev in events],
                      seed=seed, recovery=rp(**rec)))
    return tuple(out)


# -------------------------------------------------------------- vocabulary

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_schedule_keys_match_the_reference(name):
    ours, theirs = schedules(name, ["b", "a"])
    assert ours.key() == theirs.key()
    assert ours.stages() == theirs.stages()
    assert bool(ours) == bool(theirs)
    for s in ("a", "b"):
        sf, rf = ours.stage(s), theirs.stage(s)
        assert sf.events == rf.events
        assert sf.crashes() == rf.crashes()
        assert sf.recovery.key() == rf.recovery.key()
        for t in np.linspace(0.0, 5.0, 41):
            assert sf.slowdown_at(t) == rf.slowdown_at(t)
            assert sf.error_p(t) == rf.error_p(t)
        assert np.array_equal(sf.rng().random(16), rf.rng().random(16))
    assert ours.stage("c") is None and theirs.stage("c") is None
    rec = ours.recovery
    if rec.enabled:
        assert [rec.backoff(i) for i in range(1, 6)] == \
            [theirs.recovery.backoff(i) for i in range(1, 6)]


def test_the_vocabulary_validates_as_the_reference():
    for bad in [lambda: Fault("melt", "s", 0.0, 1.0, 1.0),
                lambda: crash("s", -1.0),
                lambda: Fault("crash", "s", 1.0, 2.0, 1.0),
                lambda: straggle("s", 2.0, 1.0, 3.0),
                lambda: transient("s", 0.0, 1.0, 1.5),
                lambda: straggle("s", 0.0, 1.0, 0.5),
                lambda: RecoveryPolicy(max_attempts=0),
                lambda: RecoveryPolicy(backoff_mult=0.5)]:
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        FaultSchedule([("crash", "s", 1.0)])
    assert not FaultSchedule([]) and FaultSchedule([crash("s", 1.0)])


# -------------------------------------------------------- stage simulation

@pytest.mark.parametrize("policy", ["fifo", "edf", "slo-drop"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulate_stage_faults_matches_the_reference(name, policy):
    ready, deadline = _stage_inputs(n_s=5.0, lam=150.0, seed=7)
    ours, theirs = schedules(name, ["s"])
    args = (policy, ready, _lut(8), 8, 3, [(1.5, +1), (3.0, -1)], 0.0,
            deadline, [(2.0, 0.01)] if policy == "slo-drop" else None,
            [(4.0, "fifo")])
    got = simulate_stage_faults(*args, ours.stage("s"))
    exp = ref_stage_faults(*args, theirs.stage("s"))
    assert_same_stage(got, exp)
    if name == "crash-all":
        assert (got[0] == 1e18).any()            # stranded after the crash
    if name == "no-recovery":
        assert got[2].any()                      # failures dropped


@pytest.mark.parametrize("timeout_s", [0.0, 0.01])
def test_fault_spec_through_simulate_stage(timeout_s):
    """The queueing dispatcher hands a non-empty spec to the fault loop,
    with the fifo formation hold."""
    from repro.sim.queueing import simulate_stage as ref_simulate_stage
    from repro_torch.sim.queueing import simulate_stage
    ready, deadline = _stage_inputs(n_s=4.0, lam=200.0, seed=11)
    ours, theirs = schedules("mixed", ["s"])
    args = ("fifo", ready, _lut(4), 4, 2, None, timeout_s, deadline)
    assert_same_stage(simulate_stage(*args, fault_spec=ours.stage("s")),
                      ref_simulate_stage(*args,
                                         fault_spec=theirs.stage("s")))


# ------------------------------------------------------- engine, sessions

@pytest.fixture(scope="module", params=["image", "social"])
def both(request, image_pipeline, social_pipeline):
    ref_pipe, ref_store = {"image": image_pipeline,
                           "social": social_pipeline}[request.param]
    return ref_pipe, ref_store, port_pipeline(ref_pipe), port_store(ref_store)


def test_sessions_interleave_clean_and_faulty_runs(both):
    """One session of each package: clean, faulty, clean again and a
    second schedule; every result equal to the reference's, and the
    clean runs equal before and after (the cone keys carry the faults)."""
    ref_pipe, ref_store, pipe, store = both
    from repro_torch.core.pipeline import PipelineConfig, StageConfig
    arrivals = np.sort(np.random.default_rng(5).uniform(0.0, 8.0, 900))
    config = PipelineConfig({s: StageConfig("cpu-1", 8, 2)
                             for s in pipe.stages})
    sess = SimEngine(pipe, store).session(arrivals, slo_s=0.5)
    ref_sess = RefSimEngine(ref_pipe, ref_store).session(arrivals,
                                                         slo_s=0.5)
    stages = list(pipe.stages)
    runs = [None, schedules("mixed", stages[:1]), None,
            schedules("hedged", stages), schedules("mixed", stages[:1])]
    clean = None
    for fs in runs:
        ours = sess.simulate(config, fault_schedules=fs and fs[0])
        theirs = ref_sess.simulate(to_ref(config),
                                   fault_schedules=fs and fs[1])
        assert_same_result(ours, theirs)
        if fs is None:
            if clean is not None:
                assert_same_result(ours, clean)
            clean = ours
        else:
            assert not np.array_equal(ours.latency, clean.latency)
        states = sess.stage_states(config, fault_schedules=fs and fs[0])
        ref_states = ref_sess.stage_states(to_ref(config),
                                           fault_schedules=fs and fs[1])
        for s in stages:
            for f in ("visited", "ready", "completion"):
                assert np.array_equal(getattr(states[s], f),
                                      getattr(ref_states[s], f))
    assert sess.stats["stage_hits"] == ref_sess.stats["stage_hits"] > 0
    # one-shot simulate through the engine
    fs = schedules("transient", stages)
    assert_same_result(
        SimEngine(pipe, store).simulate(config, arrivals, slo_s=0.5,
                                        fault_schedules=fs[0]),
        RefSimEngine(ref_pipe, ref_store).simulate(
            to_ref(config), arrivals, slo_s=0.5, fault_schedules=fs[1]))


# --------------------------------------------------------------- the twin

@pytest.mark.parametrize("recovery", [True, False])
def test_control_loop_with_faults_matches_the_reference(planned, recovery):
    """The twin under a crash: the Tuner's replacement ups (failure
    recovery on) or none (off), telemetry with ``alive``, the result."""
    (ref_pipe, ref_store, ref_config, ref_info), \
        (pipe, store, config, info), spike = planned
    stage = max(config.stage_configs, key=lambda s: config[s].replicas)
    fs = FaultSchedule([crash(stage, 20.5), crash(stage, 61.0)], seed=9)
    ref_fs = RefFaultSchedule([ref_crash(stage, 20.5),
                               ref_crash(stage, 61.0)], seed=9)
    ours = ControlLoopSession(pipe, store, config, SLO).run(
        spike, ClosedLoopTuner(info, failure_recovery=recovery), faults=fs)
    theirs = RefControlLoopSession(ref_pipe, ref_store, ref_config,
                                   SLO).run(
        spike, RefClosedLoopTuner(ref_info, failure_recovery=recovery),
        faults=ref_fs)
    assert np.array_equal(ours.sim.latency, theirs.sim.latency)
    assert _events(ours.events) == _events(theirs.events)
    assert ours.replica_schedules == theirs.replica_schedules
    assert ours.replica_timeline == theirs.replica_timeline
    assert np.array_equal(ours.cost_per_hr, theirs.cost_per_hr)
    assert_same_telemetry(ours.telemetry, theirs.telemetry)
    alive = [t.stages[stage].alive for t in ours.telemetry]
    replicas = [t.stages[stage].replicas for t in ours.telemetry]
    assert any(a < r for a, r in zip(alive, replicas))   # the loss shows
    # a replacement up lands the epoch after the first crash, iff on
    first_up = [e for e in ours.events if e.stage == stage
                and e.kind == "up" and 20.5 < e.t <= 21.0]
    assert bool(first_up) == recovery


# ----------------------------------------------------------- live cluster

@pytest.mark.parametrize("frontend", ["clipper", "tfs"])
@pytest.mark.parametrize("tuned", [False, True])
def test_live_cluster_sim_matches_the_reference(planned, frontend, tuned):
    (ref_pipe, ref_store, ref_config, ref_info), \
        (pipe, store, config, info), spike = planned
    assert set(FRONTENDS) == set(REF_FRONTENDS)
    assert FRONTENDS[frontend].hop_delay_s == \
        REF_FRONTENDS[frontend].hop_delay_s
    ours = LiveClusterSim(pipe, store, config, SLO,
                          frontend=FRONTENDS[frontend]).run(
        spike, (lambda arr: run_tuner_offline(Tuner(info), arr))
        if tuned else None)
    theirs = RefLiveClusterSim(ref_pipe, ref_store, ref_config, SLO,
                               frontend=REF_FRONTENDS[frontend]).run(
        spike, (lambda arr: ref_run_tuner_offline(RefTuner(ref_info), arr))
        if tuned else None)
    assert_same_result(ours.sim, theirs.sim)
    assert np.array_equal(ours.cost_times, theirs.cost_times)
    assert np.array_equal(ours.cost_per_hr, theirs.cost_per_hr)
    assert ours.replica_timeline == theirs.replica_timeline
    assert ours.miss_rate == theirs.miss_rate
    assert ours.total_cost() == theirs.total_cost()
    assert ours.mean_cost_per_hr() == theirs.mean_cost_per_hr()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    if tuned:
        assert any(len(tl) > 1 for tl in ours.replica_timeline.values())


# ---------------------------------------------------------------- analyzer

def test_key01_det01_find_nothing_in_the_fault_copies(tmp_path):
    """KEY01 (cache-key completeness: every fault-schedule component
    reaches ``_fault_key``, its arity checked against
    ``faults/schedule.py``) and DET01 (determinism) over the fault
    copies and the modules that consume them."""
    findings, rc = _analyze(
        tmp_path, ["faults/schedule.py", "faults/simstage.py",
                   "core/policy.py", "sim/engine.py", "sim/queueing.py",
                   "sim/control.py", "serving/cluster.py"],
        "KEY01,DET01")
    assert findings == [], findings
    assert rc == 0


def test_key01_sees_a_fault_component_left_out_of_the_key(tmp_path):
    """The same run finds a fault event component dropped from
    ``_fault_key``: the rule reads the copies, not nothing."""
    findings, rc = _analyze(
        tmp_path, ["faults/schedule.py", "faults/simstage.py",
                   "core/policy.py", "sim/engine.py", "sim/queueing.py",
                   "sim/control.py", "serving/cluster.py"],
        "KEY01,DET01",
        ("sim/engine.py",
         "        (str(kind), float(t0), float(t1), float(v))",
         "        (str(kind), float(t0), float(t1))"))
    assert findings and all(f["rule"] == "KEY01" for f in findings), \
        findings
    assert rc != 0
