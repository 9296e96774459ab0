"""The port's serving path on the CPU: the executor serving a two-stage
smoke cascade, its policy queues, AND-joins, hop delays and runtime
scaling, the live control loop driving it, the stage's replica slots,
and the control-plane copies (hardware, pipeline, profiler, trace
generator) against the JAX package's originals.

The wall-clock cases are the reference's (``tests/test_live_executor.py``)
with the same sleep stages, parameters and timing bars."""

import functools
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hardware as jax_hardware  # noqa: E402
from repro.core.pipeline import linear_pipeline as ref_linear_pipeline  # noqa: E402
from repro.core.profiler import ModelProfile as RefModelProfile  # noqa: E402
from repro.workload.generator import gamma_trace as ref_gamma_trace  # noqa: E402
from repro_torch.core.hardware import (  # noqa: E402
    HARDWARE_MENU,
    cheaper_hardware,
    get_hardware,
)
from repro_torch.core.pipeline import (  # noqa: E402
    SOURCE,
    Edge,
    Pipeline,
    PipelineConfig,
    Stage,
    StageConfig,
    linear_pipeline,
)
from repro_torch.core.profiler import (  # noqa: E402
    ModelProfile,
    ProfileStore,
    profile_model_measured,
)
from repro_torch.control import ControlEvent, ScheduleController  # noqa: E402
from repro_torch.faults import FaultSchedule, RecoveryPolicy, crash  # noqa: E402
from repro_torch.core.policy import LiveQueue  # noqa: E402
from repro_torch.core.tuner import ClosedLoopTuner, TunerPlanInfo  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SEQ,
    Frontend,
    LiveControlLoop,
    PipelineExecutor,
    make_stage,
)
from repro_torch.serving.executor import _Request  # noqa: E402
from repro_torch.serving.procpool import _scale_payloads  # noqa: E402
from repro_torch.serving.stage import SlotPool  # noqa: E402
from repro_torch.sim.result import EpochTelemetry  # noqa: E402
from repro_torch.workload import gamma_trace  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cascade():
    """The served cascade at smoke size on the CPU."""
    return (make_stage("xlstm-125m", "cpu", full=False),
            make_stage("llama3.2-1b", "cpu", full=False))


def _payload(i: int) -> np.ndarray:
    return np.random.default_rng(100 + i).integers(0, 512, SEQ,
                                                   dtype=np.int32)


def _config(pipe, batch_size, replicas=1, timeout_s=0.0):
    return PipelineConfig({s: StageConfig("h100-1", batch_size, replicas,
                                          timeout_s=timeout_s)
                           for s in pipe.stages})


# ----------------------------------------------------------------- serving

def test_executor_serves_the_cascade(cascade):
    a, b = cascade
    pipe = linear_pipeline("cascade", ["a", "b"],
                           {"a": ["h100-1"], "b": ["h100-1"]})
    ex = PipelineExecutor(pipe, _config(pipe, batch_size=4, timeout_s=0.02),
                          {"a": a.run_batch, "b": b.run_batch})
    try:
        # a burst of 12 then a trickle: batches form and are capped at 4
        arrivals = np.concatenate([np.full(12, 0.01),
                                   0.05 + np.arange(8) * 0.02])
        lat = ex.serve_trace(arrivals, _payload, timeout_s=60.0)
        outs = ex.outputs()
        sizes = ex.batch_sizes()
    finally:
        assert ex.shutdown()
    assert lat.shape == (20,) and np.isfinite(lat).all() and (lat > 0).all()
    for stage_sizes in sizes.values():
        assert stage_sizes.max() <= 4 and stage_sizes.max() > 1
        assert stage_sizes.sum() == 20
    for i, out in enumerate(outs):
        assert out.shape == (SEQ,) and out.dtype == np.int32
        np.testing.assert_array_equal(out[:SEQ - 2], _payload(i)[2:])
        direct = b.run_batch(a.run_batch([_payload(i)]))[0]
        np.testing.assert_array_equal(out, direct)


def test_run_batch_pads_to_a_power_of_two(cascade):
    a, _ = cascade
    payloads = [_payload(i) for i in range(3)]
    together = a.run_batch(payloads)
    assert len(together) == 3
    for p, out in zip(payloads, together):
        np.testing.assert_array_equal(out[:-1], p[1:])
        np.testing.assert_array_equal(out, a.run_batch([p])[0])


def test_a_cpu_stage_captures_nothing(cascade, monkeypatch):
    """On the CPU the stage runs eagerly: its warm-up captures no CUDA
    graph, and it warms every bucket up to the Planner's batch of 128 by
    default, as the reference's example does."""
    import inspect

    from repro_torch.core.planner import MAX_BATCH

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph was made on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    for st in cascade:
        assert inspect.signature(st.warmup).parameters[
            "max_batch"].default == MAX_BATCH == 128
        st.warmup(4)
        assert st.graphs == {} and st.stream is None
        p = _payload(0)
        np.testing.assert_array_equal(st.run_batch([p])[0][:-1], p[1:])


def test_launch_counter_add_many_from_several_threads():
    """``add_many(k)`` advances the count by k, and neither it nor ``add``
    loses a launch when threads use both at once."""
    from repro_torch.kernels._build import LaunchCounter

    c = LaunchCounter()
    c.add_many(5)
    c.add()
    assert c.count == 6
    c.reset()
    assert c.count == 0

    def work(i):
        for _ in range(2000):
            if i % 2:
                c.add_many(3)
            else:
                c.add()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # switch threads as often as it can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert c.count == 4 * 2000 * 1 + 4 * 2000 * 3


def test_profile_fn_feeds_the_measured_profiler(cascade):
    _, b = cascade
    prof = profile_model_measured("b", b.profile_fn, "h100-1",
                                  batch_sizes=(1, 2), repeats=1)
    assert set(prof.table) == {("h100-1", 1), ("h100-1", 2)}
    assert all(v > 0 for v in prof.table.values())
    store = ProfileStore()
    store.add(prof)
    assert store.get("b") is prof and "b" in store


def test_a_raising_stage_fails_the_run_promptly():
    def boom(payloads):
        raise ValueError("stage exploded")

    pipe = linear_pipeline("one", ["m"], {"m": ["cpu-1"]})
    ex = PipelineExecutor(pipe, _config(pipe, batch_size=2), {"m": boom})
    try:
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="stage exploded"):
            ex.serve_trace(np.array([0.0, 0.01]), lambda i: i,
                           timeout_s=30.0)
        assert time.perf_counter() - t0 < 5.0
    finally:
        assert ex.shutdown()


def test_conditional_edge_skips_the_child():
    stages = {"a": Stage("a", "a", ("cpu-1",)), "b": Stage("b", "b", ("cpu-1",))}
    pipe = Pipeline("cond", stages, [Edge(SOURCE, "a"),
                                     Edge("a", "b", probability=0.5)])
    seen = []

    def record(payloads):
        seen.extend(payloads)
        return payloads

    ex = PipelineExecutor(pipe, _config(pipe, batch_size=8),
                          {"a": lambda p: [x + 1 for x in p], "b": record},
                          seed=3)
    try:
        lat = ex.serve_trace(np.arange(40) * 0.002, lambda i: 10 * i)
    finally:
        assert ex.shutdown()
    assert np.isfinite(lat).all()
    assert 0 < len(seen) < 40
    assert set(seen) <= {10 * i + 1 for i in range(40)}


@pytest.mark.parametrize("bad", ["faults", "retry", "process"])
def test_executor_rejects_what_this_slice_does_not_serve(bad):
    """Fault injection, retries and the process backend, which the port
    refused before it had them, are served now; an unknown backend still
    raises. (The process backend's serving cases spawn workers and live
    in ``tests/test_torch_procpool.py``.)"""
    pipe = linear_pipeline("one", ["m"], {"m": ["cpu-1"]})
    with pytest.raises(ValueError, match="backend"):
        PipelineExecutor(pipe, _config(pipe, batch_size=1),
                         {"m": lambda p: p}, backend="gpu")
    calls = []

    def flaky(payloads):
        calls.append(len(payloads))
        if len(calls) == 1:
            raise ValueError("first batch fails")
        time.sleep(0.01)
        return [x + 1 for x in payloads]

    if bad == "process":
        # one spawned worker: the fn must pickle, so a module-level one
        ex = PipelineExecutor(pipe, _config(pipe, batch_size=2),
                              {"m": functools.partial(_scale_payloads,
                                                      scale=3)},
                              backend="process")
        try:
            lat = ex.serve_trace(np.linspace(0.0, 0.05, 6), lambda i: i,
                                 timeout_s=20.0)
            assert np.isfinite(lat).all()
            assert ex.outputs() == [3 * i for i in range(6)]
            assert ex.worker_pids("s0_m")[0] != os.getpid()
            assert ex.dataplane_stats()["s0_m"].pickle_batches > 0
        finally:
            assert ex.shutdown()
        assert ex.live_process_count("s0_m") == 0
        return
    kwargs = {"faults": {"faults": FaultSchedule([crash("s0_m", 0.03)])},
              "retry": {"retry": RecoveryPolicy(max_attempts=3,
                                                backoff_s=0.01)}}[bad]
    ex = PipelineExecutor(pipe, _config(pipe, batch_size=2, replicas=2),
                          {"m": flaky if bad == "retry"
                           else lambda p: (time.sleep(0.02), p)[1]},
                          **kwargs)
    try:
        lat = ex.serve_trace(np.linspace(0.0, 0.1, 8), lambda i: i,
                             timeout_s=10.0)
        outs = ex.outputs()
    finally:
        assert ex.shutdown()
    assert np.isfinite(lat).all()
    if bad == "faults":
        assert outs == list(range(8))
        assert [d for _, d in ex.fault_deltas()["s0_m"]] == [-1]
        assert ex.replica_target("s0_m") == 1
    else:
        assert outs == [i + 1 for i in range(8)]
        assert sum(calls) > 8            # the failed batch was served again


def test_fifo_queue_holds_a_partial_batch_until_its_timeout():
    """The executor's queue is the policy core's ``LiveQueue``: its fifo
    formation hold keeps a partial batch until the timeout or a full
    batch."""
    q = LiveQueue("fifo", timeout_s=0.1)
    for i in range(3):
        q.push(i, ready=0.0)
    assert q.form_batch(0.05, max_batch=4) == ([], [])
    assert q.next_ready_after(0.05, max_batch=4) == pytest.approx(0.1)
    assert q.form_batch(0.1, max_batch=4) == ([0, 1, 2], [])
    for i in range(5):
        q.push(i, ready=1.0)
    assert q.form_batch(0.5, max_batch=4) == ([], [])          # none ready
    assert q.form_batch(1.0, max_batch=4) == ([0, 1, 2, 3], [])  # full
    assert len(q) == 1


# ----------------------------------------------------- control-plane copies

@pytest.mark.parametrize("seed,lam,cv", [(0, 20.0, 1.0), (1, 100.0, 4.0)])
def test_gamma_trace_matches_the_reference(seed, lam, cv):
    np.testing.assert_array_equal(gamma_trace(lam, cv, 10.0, seed=seed),
                                  ref_gamma_trace(lam, cv, 10.0, seed=seed))


def test_pipeline_copy_matches_the_reference():
    ours = linear_pipeline("p", ["a", "b", "c"], {"a": ["cpu-1"]})
    theirs = ref_linear_pipeline("p", ["a", "b", "c"], {"a": ["cpu-1"]})
    assert ours.toposort() == theirs.toposort()
    assert ours.scale_factors() == theirs.scale_factors()
    assert [(e.src, e.dst) for e in ours.edges] == \
        [(e.src, e.dst) for e in theirs.edges]
    with pytest.raises(ValueError):
        StageConfig("cpu-1", batch_size=0, replicas=1)


def test_profile_interpolation_matches_the_reference():
    table = {("h100-1", 1): 0.004, ("h100-1", 4): 0.007,
             ("h100-1", 16): 0.02}
    ours = ModelProfile("m", dict(table), (1, 4, 16))
    theirs = RefModelProfile("m", dict(table), (1, 4, 16))
    for b in (1, 2, 3, 4, 9, 16, 40):
        assert ours.batch_latency("h100-1", b) == \
            theirs.batch_latency("h100-1", b)
    assert ours.best_batch("h100-1") == theirs.best_batch("h100-1")


def test_hardware_menu_adds_one_h100():
    h100 = get_hardware("h100-1")
    assert (h100.chips, h100.peak_flops, h100.mem_bw) == (1, 989e12, 3.35e12)
    ref_menu = {h.name: h for h in jax_hardware.HARDWARE_MENU}
    ours = {h.name: h for h in HARDWARE_MENU}
    assert set(ours) == set(ref_menu) | {"h100-1"}
    for name, h in ref_menu.items():
        assert ours[name].__dict__ == h.__dict__
    with pytest.raises(KeyError):
        get_hardware("a100-1")


def test_h100_has_a_price_and_the_downgrades_match_the_reference():
    h100 = get_hardware("h100-1").cost_per_hr
    assert np.isfinite(h100) and h100 > 0
    for h in jax_hardware.HARDWARE_MENU:
        ours = cheaper_hardware(h.name)
        # the reference's answer, with h100-1 in its menu place where it
        # is the cheaper of the two
        assert [n for n in ours if n != "h100-1"] == \
            list(jax_hardware.cheaper_hardware(h.name))
        assert ("h100-1" in ours) == (h100 < h.cost_per_hr)
    assert "h100-1" not in cheaper_hardware("h100-1")
    assert all(get_hardware(n).cost_per_hr < h100
               for n in cheaper_hardware("h100-1"))
    pipe = linear_pipeline("c", ["a", "b"])
    cost = _config(pipe, 8, replicas=2).cost_per_hr()
    assert np.isfinite(cost) and cost == 4 * h100
    assert all(np.isfinite(h.cost_per_hr) for h in HARDWARE_MENU)


def test_make_stage_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        make_stage("llama3.2-1b", full=False)


# ------------------------------------------- the live executor and loop

def _sleep_fn(per_batch_s, counter=None):
    def fn(payloads):
        if counter is not None:
            counter.append(len(payloads))
        time.sleep(per_batch_s)
        return list(payloads)
    return fn


def _linear(n_stages=1, batch=4, replicas=1, policy="fifo"):
    names = [f"m{i}" for i in range(n_stages)]
    pipe = linear_pipeline("t", names, {n: ["cpu-1"] for n in names})
    cfg = PipelineConfig({
        s: StageConfig("cpu-1", batch, replicas, policy=policy)
        for s in pipe.stages})
    return pipe, cfg


def _diamond(prob_c=1.0):
    """a -> (b, c) -> d; the c branch optionally conditional."""
    stages = {n: Stage(n, n, ("cpu-1",)) for n in "abcd"}
    edges = [Edge(SOURCE, "a"), Edge("a", "b"),
             Edge("a", "c", probability=prob_c),
             Edge("b", "d"), Edge("c", "d")]
    pipe = Pipeline("diamond", stages, edges)
    cfg = PipelineConfig({s: StageConfig("cpu-1", 4, 1) for s in stages})
    return pipe, cfg, {n: _sleep_fn(0.002) for n in "abcd"}


def test_shutdown_joins_all_workers_mid_load():
    """shutdown() joins every worker, even called mid-load, twice."""
    pipe, cfg = _linear(n_stages=2, replicas=3)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.01),
                                      "m1": _sleep_fn(0.01)})
    workers = [t for st in ex._stages.values() for t in st.workers]
    for i in range(40):
        ex.inject(_Request(i, ex.now(), i))
    assert ex.shutdown(join_timeout_s=5.0)
    assert ex.shutdown(join_timeout_s=1.0)      # idempotent
    assert len(workers) == 6 and not any(t.is_alive() for t in workers)


def test_scale_down_drains_in_service_batch():
    """Retiring a replica lets its in-service batch complete (no request
    is ever abandoned) and the thread exits afterwards."""
    pipe, cfg = _linear(replicas=2, batch=2)
    sizes = []
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.15, sizes)})
    reqs = [_Request(i, ex.now(), i) for i in range(6)]
    for r in reqs:
        ex.inject(r)
    time.sleep(0.05)                  # both workers mid-batch
    ex.retire_replicas("s0_m0", 1)
    assert ex.replica_target("s0_m0") == 1
    for r in reqs:
        assert r.done.wait(5.0), "request lost during scale-down drain"
    deadline = time.time() + 2.0
    while ex.live_worker_count("s0_m0") > 1 and time.time() < deadline:
        time.sleep(0.02)
    assert ex.live_worker_count("s0_m0") == 1
    assert ex.shutdown()


def test_scale_up_with_activation_delay():
    """add_replicas(t_active) workers do not serve before t_active — the
    runtime analogue of the engine's (t, +1) activation events."""
    pipe, cfg = _linear(replicas=1, batch=1)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.3)})
    t_act = ex.now() + 0.35
    ex.add_replicas("s0_m0", 1, t_active=t_act)
    reqs = [_Request(i, ex.now(), i) for i in range(3)]
    for r in reqs:
        ex.inject(r)
    for r in reqs:
        assert r.done.wait(5.0)
    # the original replica can finish exactly one 300 ms batch before
    # t_act = 0.35; were the new worker serving from t=0, a second
    # completion would land by ~0.3 as well
    assert sum(1 for r in reqs if r.t_done < t_act) <= 1
    timeline = ex.replica_timeline["s0_m0"]
    assert timeline[0][1] == 1 and timeline[-1][1] == 2
    assert timeline[-1][0] == pytest.approx(t_act)
    ex.scale("s0_m0", 1)
    assert ex.replica_target("s0_m0") == 1
    assert ex.shutdown()


def test_a_replica_waiting_for_activation_takes_no_wake_up():
    """Replicas added with a future activation wait on the stage's
    condition beside the active one. An arrival wakes every worker, so
    the active replica serves it at once instead of sleeping out its
    timed wait while a waiting replica takes the only wake-up."""
    pipe, cfg = _linear(replicas=1, batch=4)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.001)})
    ex.add_replicas("s0_m0", 3, t_active=ex.now() + 1e6)
    time.sleep(0.3)
    lat = []
    for i in range(20):
        r = _Request(i, ex.now(), i)
        ex.inject(r)
        assert r.done.wait(5.0)
        lat.append(r.t_done - r.t_arrival)
        time.sleep(0.037)
    assert ex.shutdown()
    # a lost wake-up costs the active worker's timed wait (up to 0.25 s)
    assert np.median(lat) < 0.05, lat


def test_serve_trace_releases_timed_out_requests():
    """A timed-out serve_trace reports inf AND cancels the backlog so
    stages stop grinding through work nobody waits for."""
    pipe, cfg = _linear(replicas=1, batch=1)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.25)})
    trace = np.linspace(0.0, 0.05, 12)      # ~3 s of service, 0.6 s budget
    lat = ex.serve_trace(trace, lambda i: i, timeout_s=0.6)
    assert np.isinf(lat).any()
    assert np.isfinite(lat).any()
    deadline = time.time() + 2.0
    while time.time() < deadline:
        if ex.telemetry_counters()["s0_m0"]["queue_depth"] == 0:
            break
        time.sleep(0.05)
    assert ex.telemetry_counters()["s0_m0"]["queue_depth"] == 0
    assert ex.outputs().count(None) == int(np.isinf(lat).sum())
    assert ex.shutdown()


def test_executor_reuse_after_timed_out_run():
    """Request ids restart at 0 every run: a second run on the same
    executor does not collide with run 1's released backlog."""
    pipe, cfg = _linear(replicas=1, batch=1)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.2)})
    lat1 = ex.serve_trace(np.zeros(8), lambda i: i, timeout_s=0.3)
    assert np.isinf(lat1).any()
    lat2 = ex.serve_trace(np.linspace(0, 0.2, 4), lambda i: i,
                          timeout_s=10.0)
    assert np.isfinite(lat2).all(), lat2
    assert (lat2 > 0).all()
    assert ex.shutdown()


def test_live_slo_drop_sheds_and_reports_inf():
    pipe, cfg = _linear(replicas=1, batch=4, policy="slo-drop")
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.2)},
                          solo_latency_s={"s0_m0": 0.2})
    # one long batch occupies the replica; the backlog behind it has
    # deadlines too tight to survive the wait and is shed
    lat = ex.serve_trace(np.zeros(6), lambda i: i, timeout_s=5.0,
                         slo_s=0.25)
    assert np.isinf(lat).sum() >= 1, lat
    assert np.isfinite(lat).sum() >= 1
    assert ex.telemetry_counters()["s0_m0"]["dropped"] >= 1
    outs = ex.outputs()
    assert all((o is None) == bool(np.isinf(x)) for o, x in zip(outs, lat))
    assert ex.shutdown()


def test_live_edf_serves_urgent_first():
    pipe, cfg = _linear(replicas=1, batch=1, policy="edf")
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.2)})
    ex.start_run()
    blocker = _Request(0, ex.now(), 0, deadline=99.0)
    ex.inject(blocker)                 # occupies the replica
    time.sleep(0.05)
    relaxed = _Request(1, ex.now(), 1, deadline=50.0)
    ex.inject(relaxed)
    urgent = _Request(2, ex.now(), 2, deadline=1.0)   # arrives later
    ex.inject(urgent)
    for r in (blocker, relaxed, urgent):
        assert r.done.wait(5.0)
    assert urgent.t_done < relaxed.t_done
    assert ex.shutdown()


def test_live_policy_switch_and_shed_margin_events():
    pipe, cfg = _linear(replicas=1, batch=2)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.02)})
    ex.apply_control_event(
        ControlEvent(0.0, 0.0, "s0_m0", "policy", 0.0, policy="edf"))
    assert ex._stages["s0_m0"].queue.policy == "edf"
    ex.apply_control_event(ControlEvent(0.0, 0.0, "s0_m0", "shed", 0.1))
    assert ex._stages["s0_m0"].queue.shed_margin == pytest.approx(0.1)
    with pytest.raises(ValueError):
        ex.apply_control_event(ControlEvent(0.0, 0.0, "nope", "up", 1))
    with pytest.raises(ValueError):
        ex.apply_control_event(
            ControlEvent(0.0, 0.0, "s0_m0", "policy", 0.0))
    assert ex.shutdown()


def test_executor_timeout_hold_batches_sparse_arrivals():
    """Two sparse arrivals within one hold window serve as ONE batch."""
    pipe = linear_pipeline("t", ["m0"], {"m0": ["cpu-1"]})
    cfg = PipelineConfig({s: StageConfig("cpu-1", 2, 1, timeout_s=0.4)
                          for s in pipe.stages})
    sizes = []
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.01, sizes)})
    ex.start_run()
    r0 = _Request(0, ex.now(), 0)
    ex.inject(r0)
    time.sleep(0.15)                  # well inside the 0.4 s hold
    r1 = _Request(1, ex.now(), 1)
    ex.inject(r1)
    for r in (r0, r1):
        assert r.done.wait(5.0)
    assert sizes and sizes[0] == 2, sizes   # held and served together
    assert r0.t_done >= r1.t_arrival
    assert ex.shutdown()


@pytest.mark.parametrize("prob_c", [1.0, 0.5])
def test_diamond_and_join_serves_each_request_once(prob_c):
    """The AND-join stage d serves each request exactly once, after every
    parent reported: with a 0.5-probability branch the branch that did
    not fire sends an anti-token instead of leaving the barrier
    hanging."""
    pipe, cfg, fns = _diamond(prob_c)
    ex = PipelineExecutor(pipe, cfg, fns)
    done_rids = []
    done_lock = threading.Lock()

    def on_done(req):
        with done_lock:
            done_rids.append(req.rid)

    ex.on_request_done = on_done
    try:
        lat = ex.serve_trace(np.linspace(0.0, 0.3, 30), lambda i: i,
                             timeout_s=20.0)
        counters = ex.telemetry_counters()
    finally:
        assert ex.shutdown()
    assert np.isfinite(lat).all(), lat
    assert sorted(done_rids) == list(range(30))      # exactly once each
    assert counters["d"]["arrived"] == 30            # once, not per parent
    if prob_c < 1.0:
        assert 0 < counters["c"]["arrived"] < 30     # the coin flipped
    else:
        assert counters["c"]["arrived"] == 30


def test_frontend_hop_delays_every_hand_off_and_the_reply():
    """A frontend's hop delay lands on the entry hop, each inter-stage
    hand-off and the reply hop: three hops through two stages."""
    hop = 0.05
    slow = Frontend("slow", rpc_delay_s=hop, serialization_s=0.0)
    assert slow.hop_delay_s == hop
    pipe, cfg = _linear(n_stages=2, replicas=1, batch=4)
    fns = {"m0": _sleep_fn(0.001), "m1": _sleep_fn(0.001)}
    lat = {}
    for name, frontend in (("none", None), ("slow", slow)):
        ex = PipelineExecutor(pipe, cfg, fns, frontend=frontend)
        try:
            lat[name] = ex.serve_trace(np.arange(5) * 0.2, lambda i: i,
                                       timeout_s=10.0)
        finally:
            assert ex.shutdown()
    assert np.isfinite(lat["slow"]).all()
    assert (lat["slow"] >= 3 * hop).all(), lat["slow"]
    assert (lat["none"] < 3 * hop).all(), lat["none"]


def test_live_loop_schedule_controller_scales_up_and_down():
    """The LiveControlLoop lands the same ControlEvents the co-sim loop
    folds — scale up (activation-delayed) then back down (drained) —
    and records them in the replica timeline."""
    pipe, cfg = _linear(replicas=1, batch=4)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.01)})
    loop = LiveControlLoop(ex, slo=0.5, epoch_s=0.5, service_time_s=0.01,
                           drain_timeout_s=5.0)
    stage = "s0_m0"
    sched = ScheduleController([
        ControlEvent(1.0, 1.5, stage, "up", 2),
        ControlEvent(3.0, 3.0, stage, "down", -2),
    ])
    trace = gamma_trace(40, 1.0, 4, seed=0)
    res = loop.run(trace, sched, lambda i: i)
    assert [e.kind for e in res.events] == ["up", "down"]
    assert res.replica_schedules[stage] == [(1.5, 2), (3.0, -2)]
    assert res.replica_timeline[stage] == [(0.0, 1), (1.5, 3), (3.0, 1)]
    assert res.released == 0
    assert np.isfinite(res.latency).all()
    assert res.miss_rate < 0.5
    # telemetry: epochs partition [0, t_stop]; every injection landing
    # at/before the last boundary is counted in exactly one window
    assert len(res.telemetry) == int(trace.max() // 0.5)
    t_last = res.telemetry[-1].t_end
    in_epochs = int(np.searchsorted(res.arrival, t_last, side="right"))
    assert sum(t.ingress for t in res.telemetry) == in_epochs
    assert all(isinstance(t, EpochTelemetry) for t in res.telemetry)
    by_t = {t.t_end: t.stages[stage].replicas for t in res.telemetry}
    assert by_t[1.0] == 1 and by_t[2.0] == 3 and by_t[3.5] == 1
    assert res.total_cost() > 0.0
    assert ex.shutdown()


def test_live_loop_closed_loop_tuner_scales_real_threads():
    """ClosedLoopTuner — unchanged from co-simulation — reacts to a real
    spike on the real executor."""
    fn = _sleep_fn(0.004)
    pipe, cfg = _linear(replicas=2, batch=4)
    store = ProfileStore()
    store.add(profile_model_measured("m0", lambda b: fn([0] * b),
                                     batch_sizes=(1, 2, 4), repeats=2))
    lut1 = store.get("m0").batch_latency("cpu-1", 1)
    sample = gamma_trace(30, 1.0, 4, seed=0)
    info = TunerPlanInfo.from_plan(pipe, cfg, store, sample, lut1)
    ex = PipelineExecutor(pipe, cfg, {"m0": fn},
                          solo_latency_s={"s0_m0": lut1})
    loop = LiveControlLoop(ex, slo=0.15, epoch_s=0.5, service_time_s=lut1,
                           drain_timeout_s=5.0)
    trace = np.concatenate([sample, 4.0 + gamma_trace(250, 0.5, 2, seed=1)])
    tuner = ClosedLoopTuner(info, activation_delay_s=0.5)
    res = loop.run(trace, tuner, lambda i: i)
    ups = [e for e in res.events if e.kind == "up"]
    assert ups, "closed-loop tuner never scaled the real executor"
    assert res.replica_timeline["s0_m0"][-1][1] > 2
    assert np.isfinite(res.latency).mean() > 0.9
    assert ex.shutdown()


def test_live_loop_t_end_interrupts_idle_injector():
    """A t_end before a far-future arrival ends the run promptly; the
    pending arrival is never injected."""
    pipe, cfg = _linear(replicas=1, batch=2)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.005)})
    loop = LiveControlLoop(ex, slo=0.5, epoch_s=0.5, drain_timeout_s=2.0)
    t0 = time.time()
    res = loop.run(np.array([0.1, 0.2, 30.0]), ScheduleController([]),
                   lambda i: i, t_end=1.5)
    assert time.time() - t0 < 10.0
    assert res.latency.size == 2
    assert np.isfinite(res.latency).all()
    with pytest.raises(ValueError):
        loop.run(np.array([1.0, 0.5]), ScheduleController([]), lambda i: i)
    assert ex.shutdown()


def test_a_crashing_stage_fails_the_live_loop():
    """A worker crash wakes the epoch loop and fails the run at once."""
    def boom(payloads):
        raise ValueError("stage exploded")

    pipe, cfg = _linear(replicas=1, batch=2)
    ex = PipelineExecutor(pipe, cfg, {"m0": boom})
    loop = LiveControlLoop(ex, slo=0.5, epoch_s=0.5, drain_timeout_s=5.0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="stage exploded"):
        loop.run(np.linspace(0.1, 3.0, 10), ScheduleController([]),
                 lambda i: i)
    assert time.perf_counter() - t0 < 2.5
    assert ex.shutdown()


# ------------------------------------------------------------ replica slots

def test_slot_pool_hands_out_the_lowest_free_slot_and_waits_when_busy():
    """Slot 0 serves whenever it is free; a taker finding every slot busy
    waits until one is given back, then holds it alone."""
    pool = SlotPool()
    for name in ("s0", "s1"):
        pool.add(name)
    with pool.take() as a:
        assert a == "s0"
        with pool.take() as b:
            assert b == "s1"
            got = []
            waiter = threading.Thread(
                target=lambda: got.append(pool.take().__enter__()))
            waiter.start()
            waiter.join(0.2)
            assert waiter.is_alive() and got == []   # all busy: waits
        waiter.join(5.0)
        assert not waiter.is_alive() and got == ["s1"]


def test_slot_pool_never_gives_one_slot_to_two_holders():
    """Eight threads share three slots under a short switch interval: no
    slot ever has two holders, and every taker gets one."""
    pool = SlotPool()
    for i in range(3):
        pool.add(i)
    holders = [0, 0, 0]
    lock = threading.Lock()
    errors = []

    def work():
        for _ in range(300):
            with pool.take() as i:
                with lock:
                    holders[i] += 1
                    if holders[i] != 1:
                        errors.append(i)
                with lock:
                    holders[i] -= 1

    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and holders == [0, 0, 0]
    assert sorted(pool._free) == [0, 1, 2]


def test_a_cpu_stage_has_no_slots(cascade):
    """On the CPU a stage captures nothing, whatever slots it is asked
    for, and serves from several threads at once eagerly."""
    a, _ = cascade
    a.warmup(2, slots=4)
    assert a.pool.slots == [] and a.graphs == {}
    rows = [_payload(i) for i in range(6)]
    want = [a.run_batch([r])[0] for r in rows]
    got = [None] * len(rows)

    def serve(k):
        got[k] = a.run_batch([rows[k]])[0]

    threads = [threading.Thread(target=serve, args=(k,))
               for k in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
