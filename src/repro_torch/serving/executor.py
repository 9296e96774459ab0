"""Wall-clock pipeline executor of the port: policy-aware centralized
batched queues and replica workers serving the port's stages.

A copy of the reference's ``repro/serving/executor.py:
PipelineExecutor``. It keeps the three properties InferLine asks of a
serving runtime (§3):

* a **centralized batched queue per stage**, driven by the SAME policy
  core as the simulator (:class:`repro_torch.core.policy.LiveQueue`):
  fifo with the formation hold of ``StageConfig.timeout_s`` (a partial
  batch stays queued until ``timeout_s`` past the head-of-line ready
  instant or until the batch fills), edf (per-query deadlines), and
  slo-drop with a runtime-reprogrammable shed margin, plus mid-run
  policy switching;
* the **maximum batch size** of ``StageConfig.batch_size``, enforced at
  formation;
* **runtime replica scaling in BOTH directions**: scale-up spawns
  workers (optionally activating only after a modeled activation delay,
  like the engine's ``(t, +1)`` events), scale-down *drains* — a
  retiring worker finishes its in-service batch, never abandons it.

Two backends. ``"thread"``: every replica is a thread calling the
stage function, so GPU stages share one copy of their weights; on CUDA
each batch takes one of the stage's replica slots
(:mod:`repro_torch.serving.stage`). ``"process"``: every replica's
dispatcher thread pairs with a worker OS process
(:mod:`repro_torch.serving.procpool`) fed through a shared-memory ring;
a :class:`~repro_torch.serving.stage.ProcessStage` builds its own copy
of the stage on its own card there.

Shutdown is condition-variable based: no queue sentinels, so there is
no sentinel/batch-assembly race — ``shutdown()`` joins every worker.

The executor also exposes the control-plane surface the closed-loop
Tuner drives: :meth:`PipelineExecutor.apply_control_event` accepts the
same :class:`repro_torch.control.ControlEvent` s the co-simulation folds,
and :meth:`telemetry_counters` feeds the
:class:`repro_torch.serving.loop.LiveControlLoop` driver that assembles
real :class:`~repro_torch.sim.result.EpochTelemetry` records.

**Fault injection** (:mod:`repro_torch.faults`): constructed with a
``FaultSchedule``, the executor kills real workers on the crash schedule
(a per-run driver thread calls :meth:`PipelineExecutor.crash_replicas`;
an in-service victim's batch requeues, never lost — with the process
backend the victim is a worker process, SIGKILLed), stretches batch
service inside straggle windows, and fails batches inside error windows
from a per-stage seeded substream (same ``[seed, crc32(stage)]``
convention as the sim path). Failed work is retried under the
schedule's :class:`~repro_torch.faults.schedule.RecoveryPolicy` —
bounded attempts, exponential backoff, optional hedged duplicate near
the deadline — with exactly-once delivery enforced by per-(request,
stage) resolve-once claims.

A stage function that raises fails the run unless a recovery policy
retries it (``retry=``, or a fault schedule's): the exception is
recorded, the waiting driver wakes, and :meth:`PipelineExecutor
.serve_trace` (or the control loop) raises instead of returning
latencies that silently under-serve. The reference instead answers such
a batch with ``None`` payloads.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.control import ControlEvent
from repro_torch.core.pipeline import Pipeline, PipelineConfig
from repro_torch.core.policy import LiveQueue
from repro_torch.faults.schedule import (
    FaultSchedule,
    InjectedFault,
    RecoveryPolicy,
    StageFaults,
)
from repro_torch.serving.dataplane import DataplaneStats
from repro_torch.serving.frontends import Frontend
from repro_torch.serving.procpool import (
    DEFAULT_SLAB_BYTES,
    ProcessReplicaPool,
    ProcReplica,
    ReplicaDead,
    StageWorkerError,
)

StageFn = Callable[[List[Any]], List[Any]]


@dataclasses.dataclass
class _Request:
    rid: int
    t_arrival: float                    # executor-clock seconds (nominal)
    payload: Any
    deadline: float = float("inf")      # executor-clock seconds
    t_done: Optional[float] = None
    shed: bool = False                  # shed by an slo-drop stage
    cancelled: bool = False             # released by a timed-out driver
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    # routing state lives ON the request (object identity), so a stale
    # request draining after a run reset can never corrupt the
    # bookkeeping of a new run that reuses its rid
    visited: set = dataclasses.field(default_factory=set)  # guarded-by: _lock
    pending: int = 0                    # guarded-by: _lock (branches in flight)
    # per-stage delivery attempt count (1 = first try) for bounded retry
    attempts: dict = dataclasses.field(default_factory=dict)  # guarded-by: _lock
    # stages where this request already resolved (delivered, shed, or
    # given up) — hedged duplicate queue entries lose against this set
    resolved_stages: set = dataclasses.field(default_factory=set)  # guarded-by: _lock
    # AND-join barrier: per-stage count of parent messages received and
    # the max readiness over *firing* parents (see _route_child)
    join_msgs: dict = dataclasses.field(default_factory=dict)  # guarded-by: _lock
    join_ready: dict = dataclasses.field(default_factory=dict)  # guarded-by: _lock


class _Stage:
    """One centralized policy queue + its replica workers."""

    def __init__(self, name: str, fn: StageFn, max_batch: int, policy: str,
                 solo_latency_s: float, timeout_s: float = 0.0,
                 fault_rng: Optional[np.random.Generator] = None,
                 pool: Optional[ProcessReplicaPool] = None):
        self.name = name
        self.fn = fn
        # process backend: each dispatcher thread pairs with one worker
        # process from this pool (None = thread backend, fn runs inline).
        # The pool carries its own lock; it is NOT guarded by cond.
        self.pool = pool
        self.max_batch = max_batch
        self.solo_latency_s = solo_latency_s
        self.queue = LiveQueue(policy, timeout_s=timeout_s)  # guarded-by: cond
        self.cond = threading.Condition()
        self.workers: List[threading.Thread] = []      # guarded-by: cond
        self.target = 0                 # guarded-by: cond (replica target)
        self.retire_pending = 0         # guarded-by: cond
        self.kill_pending = 0           # guarded-by: cond (injected crashes)
        # per-stage substream for injected transient errors (drawn in
        # batch-dispatch order, like the sim's StageFaults.rng())
        self.fault_rng = fault_rng      # guarded-by: cond
        self.stop = False               # guarded-by: cond
        # cumulative counters (run-relative; reset by start_run)
        self.arrived = 0                # guarded-by: cond
        self.completed = 0              # guarded-by: cond
        self.dropped = 0                # guarded-by: cond
        self.in_flight = 0              # guarded-by: cond
        self.batch_log: List[Tuple[float, int]] = []   # guarded-by: cond


class PipelineExecutor:
    """Deploys a configured pipeline over real worker threads or worker
    processes.

    Args:
      pipeline: the DAG; conditional edges are sampled per request from
        ``seed``.
      config: per-stage (hardware*, batch, replicas, policy, timeout) —
        hardware is informational; batch/replicas/policy/timeout are
        enforced.
      stage_fns: model_id -> callable(List[payload]) -> List[payload]
        (the process backend also takes a worker factory such as
        :class:`~repro_torch.serving.stage.ProcessStage`).
      solo_latency_s: per-stage batch-1 service latency (seconds) — the
        slo-drop viability floor (``deadline < now + solo + margin``).
        Take it from the measured profile's ``lut[1]``; defaults to 0
        (shed only queries already past their deadline).
      frontend: optional :class:`~repro_torch.serving.frontends.Frontend`
        whose ``hop_delay_s`` is applied to every inter-stage hand-off
        (a request becomes batchable ``hop_delay_s`` after its parent
        completes) and to the reply hop — mirroring the simulator's
        ``rpc_delay_s`` so sim<->real comparisons model the same
        network. Default: no hop delay.
      faults: optional :class:`repro_torch.faults.FaultSchedule` —
        crashes are driven against the run clock by a per-run driver
        thread, straggle/error windows are consulted at each batch
        dispatch, and the schedule's recovery policy arms the retry
        machinery.
      retry: override the recovery policy without a fault schedule
        (e.g. to retry real stage-fn exceptions); defaults to
        ``faults.recovery`` when a schedule is given, else None (a
        stage-fn exception fails the run).
      backend: ``"thread"`` (default) runs stage fns inline in the
        dispatcher threads; ``"process"`` pairs every dispatcher with a
        worker OS process fed through a shared-memory ring — same
        LiveQueue/batch-formation contract, but injected crashes SIGKILL
        real processes.
      slab_bytes: per-replica shared-memory slab size for the process
        backend; split into ``ring_depth`` buffers (oversize batches
        fall back to chunked-slab transport).
      transport: process-backend data plane — ``"ring"`` (default) is
        the typed zero-copy codec with a double-buffered ring
        overlapping dispatch with compute; ``"pickle"`` is the legacy
        whole-batch-pickle lane kept for A/B comparison.
      ring_depth: ring buffers per replica (``transport="ring"``); 2 =
        double-buffered — the dispatcher assembles batch B into the
        slab while the worker computes on batch A. 1 degenerates to
        strictly synchronous dispatch.
      start_method: multiprocessing start method for worker processes:
        ``"spawn"`` (default; the reference's is ``"fork"``), because
        CUDA cannot be used in a forked child. Stage fns must then be
        importable or picklable (see
        :func:`repro_torch.serving.procpool.register_worker_fn`).

    Join semantics: AND-join with per-request barriers, mirroring the
    simulator's ``_stage_ready``. Every stage receives exactly one
    message per inbound edge per request — a firing token (parent
    completed and the edge's coin came up) or a non-firing anti-token —
    and is enqueued at most once, after ALL parents reported, iff at
    least one token fired, ready ``hop_delay_s`` after the latest
    firing parent. A stage none of whose tokens fired relays
    anti-tokens to its own children so descendants never stall.
    """

    def __init__(self, pipeline: Pipeline, config: PipelineConfig,
                 stage_fns: Dict[str, StageFn],
                 seed: int = 0,
                 solo_latency_s: Optional[Dict[str, float]] = None,
                 frontend: Optional[Frontend] = None,
                 faults: Optional[FaultSchedule] = None,
                 retry: Optional[RecoveryPolicy] = None,
                 backend: str = "thread",
                 slab_bytes: int = DEFAULT_SLAB_BYTES,
                 transport: str = "ring",
                 ring_depth: int = 2,
                 start_method: str = "spawn"):
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown executor backend {backend!r}")
        self.pipeline = pipeline
        self.config = config
        self.backend = backend
        self.rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        self._lock = threading.Lock()     # guards per-request routing state
        self._children = {s: pipeline.children(s) for s in pipeline.stages}
        self.hop_delay_s = frontend.hop_delay_s if frontend else 0.0
        self._t0 = time.perf_counter()             # guarded-by: _lock
        self.on_request_done: Optional[Callable[[_Request], None]] = None
        # invoked (outside locks) when a worker records a crash — lets a
        # driver blocked on a timed wait fail the run immediately (a
        # reference read is GIL-atomic; set it before the run starts)
        self.on_worker_failure: Optional[Callable[[], None]] = None
        # (stage, exception) per worker crash — failing loudly beats a
        # silent replica loss that deadlocks the run; injected crashes
        # are clean exits and never land here
        self.worker_failures: List[Tuple[str, BaseException]] = []  # guarded-by: _lock
        self._failed = threading.Event()
        # injection-lag telemetry of the most recent trace injection
        self._injection_stats: Optional[Dict[str, float]] = None  # guarded-by: _lock
        self._reqs: List[_Request] = []
        # fault injection + recovery (repro_torch.faults)
        self._faults = faults
        self._retry = retry if retry is not None else (
            faults.recovery if faults is not None else None)
        self._fault_specs: Dict[str, StageFaults] = {}
        if faults is not None:
            for s in pipeline.stages:
                spec = faults.stage(s)
                if spec is not None:
                    self._fault_specs[s] = spec
        # (t, -n) capacity losses from injected crashes, per stage —
        # the live analogue of the sim's crash schedule (feeds the
        # `alive` telemetry field); accessed under the stage's cond
        self._fault_deltas: Dict[str, List[Tuple[float, int]]] = {
            s: [] for s in pipeline.stages}  # guarded-by: cond
        # crash-driver thread control; touched only by the run driver
        # (start_run / shutdown), never by workers
        self._fault_stop: Optional[threading.Event] = None
        # AND-join fan-in per stage. pipeline.edges includes SOURCE
        # edges, so entry stages count the source message `inject` sends
        self._parents_n: Dict[str, int] = {}
        for e in pipeline.edges:
            self._parents_n[e.dst] = self._parents_n.get(e.dst, 0) + 1
        solo = solo_latency_s or {}
        self._stages: Dict[str, _Stage] = {}
        # (t_effective, +/-delta) per stage; the replica_timeline property
        # derives the sorted cumulative step function, so a scale-up
        # recorded at its future activation instant and a later-issued
        # but earlier-effective scale-down still render in time order
        self._timeline_deltas: Dict[str, List[Tuple[float, int]]] = {}  # guarded-by: cond
        self._base_replicas: Dict[str, int] = {}   # guarded-by: cond
        for name, stage in pipeline.stages.items():
            cfg = config[name]
            fault_rng = (np.random.default_rng(
                [int(faults.seed), zlib.crc32(name.encode())])
                if faults is not None else None)
            pool = (ProcessReplicaPool(stage_fns[stage.model_id],
                                       slab_bytes=slab_bytes,
                                       start_method=start_method,
                                       transport=transport,
                                       ring_depth=ring_depth)
                    if backend == "process" else None)
            st = _Stage(name, stage_fns[stage.model_id], cfg.batch_size,
                        cfg.policy, float(solo.get(name, 0.0)),
                        timeout_s=float(cfg.timeout_s),
                        fault_rng=fault_rng, pool=pool)
            self._stages[name] = st
            self._timeline_deltas[name] = []
            self._base_replicas[name] = cfg.replicas
            for _ in range(cfg.replicas):
                self._spawn_worker(st, t_active=0.0)
            with st.cond:       # workers are already running and racing
                st.target = cfg.replicas

    # -- clock -------------------------------------------------------------
    def now(self) -> float:
        """Seconds on the executor clock (zeroed by :meth:`start_run`)."""
        # analysis: allow LOCK01 — lock-free hot path: a float read is
        # GIL-atomic and a torn run-boundary timestamp only skews one
        # wait interval, never correctness
        return time.perf_counter() - self._t0

    def start_run(self) -> None:
        """Re-zero the clock and per-run stats for a fresh serving run.

        Stage queues are purged: requests a previous run left behind
        (released on timeout) carry pre-reset clock stamps and belong to
        nobody — they must not be served against the new clock."""
        with self._lock:
            self._t0 = time.perf_counter()
            self.worker_failures = []
            self._failed.clear()
            self._injection_stats = None
        for st in self._stages.values():
            with st.cond:
                st.arrived = st.completed = st.dropped = 0
                st.batch_log = []
                st.queue.clear()
                self._timeline_deltas[st.name] = []
                self._base_replicas[st.name] = st.target
                self._fault_deltas[st.name] = []
        self._start_fault_driver()

    # -- replica lifecycle -------------------------------------------------
    def _spawn_worker(self, st: _Stage, t_active: float) -> None:
        t = threading.Thread(target=self._worker_loop, args=(st, t_active),
                             name=f"{st.name}-replica", daemon=True)
        with st.cond:                 # workers list is shared state
            st.workers.append(t)
        t.start()

    def _note_worker_failure(self, stage: str, exc: BaseException) -> None:
        with self._lock:
            self.worker_failures.append((stage, exc))
            cb = self.on_worker_failure
        self._failed.set()
        if cb is not None:   # wake a blocked driver (e.g. the epoch wait)
            cb()

    def _record_delta(self, st: _Stage, t: float, delta: int) -> None:  # holds-lock: cond
        self._timeline_deltas[st.name].append((t, delta))

    @property
    def replica_timeline(self) -> Dict[str, List[Tuple[float, int]]]:
        """Per-stage replica-target step function, sorted by effective
        time — the same (t, count) shape the simulated loops record."""
        out: Dict[str, List[Tuple[float, int]]] = {}
        for name, st in self._stages.items():
            with st.cond:
                deltas = sorted(self._timeline_deltas[name])
                count = self._base_replicas[name]
            tl = [(0.0, count)]
            for t, d in deltas:
                count += d
                tl.append((t, count))
            out[name] = tl
        return out

    def add_replicas(self, stage: str, n: int,
                     t_active: Optional[float] = None) -> None:
        """Spawn `n` workers; they begin serving at ``t_active`` (executor
        clock) — the runtime analogue of the engine's ``(t, +1)`` events
        with activation delay. A worker process serves once it is ready,
        if that is later."""
        st = self._stages[stage]
        t_act = self.now() if t_active is None else float(t_active)
        with st.cond:
            st.target += n
            self._record_delta(st, t_act, n)
        for _ in range(n):
            self._spawn_worker(st, t_act)

    def retire_replicas(self, stage: str, n: int) -> None:
        """Retire `n` workers by draining: each exits after finishing any
        batch it is currently serving; queued work is never abandoned."""
        st = self._stages[stage]
        with st.cond:
            n = min(n, st.target)
            if n <= 0:
                return
            st.retire_pending += n
            st.target -= n
            self._record_delta(st, self.now(), -n)
            st.cond.notify_all()

    def scale(self, stage: str, replicas: int) -> None:
        """Runtime replica scaling to an absolute target — both
        directions (scale-down drains)."""
        cur = self.replica_target(stage)
        if replicas > cur:
            self.add_replicas(stage, replicas - cur)
        elif replicas < cur:
            self.retire_replicas(stage, cur - replicas)

    # -- fault injection ---------------------------------------------------
    def crash_replicas(self, stage: str, n: int = 1) -> int:
        """Kill `n` replicas of `stage` (fault injection).

        Thread backend: each victim dies at its next scheduling point —
        an idle victim exits immediately; an in-service victim dies
        *instead of delivering* and its batch requeues under the
        recovery policy (the work is never silently lost). The deaths
        are clean thread exits — injected failures must not trip the
        ``worker_failures`` crash-surfacing path reserved for real bugs.

        Process backend: the victims are real OS processes, SIGKILLed
        immediately (busy ones first). A mid-batch death surfaces as
        :class:`~repro_torch.serving.procpool.ReplicaDead` in the paired
        dispatcher thread, which requeues the in-flight batch exactly
        like the thread backend's kill path and exits cleanly.

        Returns the number killed (capped at the stage's live target).
        """
        st = self._stages[stage]
        t = self.now()
        with st.cond:
            n_eff = min(int(n), st.target)
            if n_eff <= 0:
                return 0
            if st.pool is not None:
                st.pool.kill(n_eff)
            else:
                st.kill_pending += n_eff
            st.target -= n_eff
            self._record_delta(st, t, -n_eff)
            self._fault_deltas[stage].append((t, -n_eff))
            st.cond.notify_all()
        return n_eff

    def fault_deltas(self) -> Dict[str, List[Tuple[float, int]]]:
        """Per-stage ``(t, -n)`` capacity losses from injected crashes
        this run — what the live control loop subtracts from the replica
        target to report the ``alive`` telemetry field."""
        out: Dict[str, List[Tuple[float, int]]] = {}
        for name, st in self._stages.items():
            with st.cond:
                out[name] = list(self._fault_deltas[name])
        return out

    def _start_fault_driver(self) -> None:
        """(Re)arm the crash schedule against the freshly-zeroed run
        clock. Called by :meth:`start_run`; a previous run's driver is
        stopped first so stale crash times never fire into a new run."""
        if self._fault_stop is not None:
            self._fault_stop.set()
            self._fault_stop = None
        crashes: List[Tuple[float, str, int]] = []
        for s, spec in self._fault_specs.items():
            for t, n in spec.crashes():
                crashes.append((float(t), s, int(n)))
        if not crashes:
            return
        crashes.sort()
        stop = threading.Event()
        self._fault_stop = stop
        t = threading.Thread(target=self._fault_driver_loop,
                             args=(crashes, stop), daemon=True)
        t.start()

    def _fault_driver_loop(self, crashes: List[Tuple[float, str, int]],
                           stop: threading.Event) -> None:
        for t_c, stage, n in crashes:
            while not stop.is_set():
                dt = t_c - self.now()
                if dt <= 0:
                    break
                stop.wait(min(dt, 0.05))
            if stop.is_set():
                return
            self.crash_replicas(stage, n)

    def live_worker_count(self, stage: str) -> int:
        """Worker threads actually alive (draining included)."""
        st = self._stages[stage]
        with st.cond:
            st.workers = [t for t in st.workers if t.is_alive()]
            return len(st.workers)

    def live_process_count(self, stage: str) -> int:
        """Worker OS processes alive (process backend; 0 for threads)."""
        st = self._stages[stage]
        return st.pool.alive_count() if st.pool is not None else 0

    def worker_pids(self, stage: str) -> List[int]:
        """PIDs of the stage's live worker processes (process backend)."""
        st = self._stages[stage]
        return st.pool.pids() if st.pool is not None else []

    def worker_devices(self, stage: str) -> List[Optional[str]]:
        """The card of each of the stage's live worker processes
        (process backend; None where the stage fn names no devices)."""
        st = self._stages[stage]
        return st.pool.devices() if st.pool is not None else []

    def worker_spawns(self, stage: str) -> List[Tuple[int, Optional[str],
                                                      float]]:
        """``(pid, device, spawn-to-ready seconds)`` of every worker
        process the stage started (process backend)."""
        st = self._stages[stage]
        return st.pool.spawn_log() if st.pool is not None else []

    def killed_worker_pids(self, stage: str) -> List[int]:
        """PIDs of the stage's worker processes that injected crashes (or
        a stuck shutdown) SIGKILLed (process backend)."""
        st = self._stages[stage]
        return st.pool.killed_pids() if st.pool is not None else []

    def replica_target(self, stage: str) -> int:
        st = self._stages[stage]
        with st.cond:
            return st.target

    # -- control-plane surface --------------------------------------------
    def set_shed_margin(self, stage: str, margin_s: float) -> None:
        st = self._stages[stage]
        with st.cond:
            st.queue.shed_margin = float(margin_s)
            st.cond.notify_all()

    def set_policy(self, stage: str, policy: str) -> None:
        st = self._stages[stage]
        with st.cond:
            st.queue.set_policy(policy)
            st.cond.notify_all()

    def apply_control_event(self, ev: ControlEvent) -> None:
        """Land one controller decision on the running pipeline — the
        same event vocabulary the co-simulation loop folds into engine
        schedules (:func:`repro_torch.control.fold_control_event`)."""
        if ev.stage not in self._stages:
            raise ValueError(f"control event for unknown stage {ev.stage!r}")
        if ev.kind == "up":
            self.add_replicas(ev.stage, int(ev.value), ev.t_effective)
        elif ev.kind == "down":
            self.retire_replicas(ev.stage, int(-ev.value))
        elif ev.kind == "shed":
            self.set_shed_margin(ev.stage, float(ev.value))
        elif ev.kind == "policy":
            if not ev.policy:
                raise ValueError("policy control event carries no policy")
            self.set_policy(ev.stage, ev.policy)
        else:
            raise ValueError(f"unknown control event kind {ev.kind!r}")

    # -- the worker loop ---------------------------------------------------
    def _worker_loop(self, st: _Stage, t_active: float) -> None:
        """Dispatcher thread body. With the process backend it first
        claims a paired worker process from the stage pool and always
        returns it (graceful close) on exit — including injected-death
        exits, where close() just reaps the corpse and frees the slab.
        Any exception fails the run loudly instead of stranding the
        replica's requests."""
        proc: Optional[ProcReplica] = None
        try:
            if st.pool is None:
                self._dispatch_loop(st, t_active)
            else:
                proc = st.pool.spawn()
                self._dispatch_loop_proc(st, t_active, proc)
        except Exception as e:  # noqa: BLE001 — a dead replica must fail
            self._note_worker_failure(st.name, e)
        finally:
            if proc is not None:
                st.pool.discard(proc)
                proc.close()

    def _formation_step(self, st: _Stage, t_active: float,
                        proc: Optional[ProcReplica], block: bool = True
                        ) -> Tuple[str, List[_Request], List[_Request],
                                   float]:
        """One batch-formation attempt under ``st.cond``. Returns
        ``(verdict, batch, shed, wait_s)``:

        * ``"exit"`` — the dispatcher must wind down (stop flag, paired
          process found dead while idle, injected kill, or a retire
          drain — pending counters are consumed here, between batches,
          never mid-batch);
        * ``"work"`` — a batch and/or shed set formed;
        * ``"none"`` — nothing formable right now (non-blocking mode
          only); ``wait_s`` is the suggested re-poll delay, the same
          bound the blocking mode would have slept.

        ``block=True`` sleeps on the cond until work or an exit
        condition appears. ``block=False`` is the overlapped process
        path: with batches already in the ring the caller must keep
        servicing responses, so formation may not park on the condvar.
        """
        cond = st.cond
        with cond:
            while True:
                if st.stop:
                    return "exit", [], [], 0.0
                if proc is not None and not proc.alive():
                    # our paired process was crash-killed while idle
                    # (process-backend fault injection): exit cleanly.
                    # In-flight ring batches surface as ReplicaDead in
                    # the caller's drain and requeue there.
                    return "exit", [], [], 0.0
                if st.kill_pending > 0:
                    # injected crash: die at the scheduling point — a
                    # clean return, not a worker failure
                    st.kill_pending -= 1
                    return "exit", [], [], 0.0
                if st.retire_pending > 0:
                    st.retire_pending -= 1
                    return "exit", [], [], 0.0
                now = self.now()
                if now < t_active:
                    wait = min(t_active - now, 0.1)
                    if not block:
                        return "none", [], [], wait
                    cond.wait(wait)
                    continue
                batch, shed = st.queue.form_batch(
                    now, st.max_batch, st.solo_latency_s)
                if batch or shed:
                    return "work", batch, shed, 0.0
                nxt = st.queue.next_ready_after(now, st.max_batch)
                wait = (0.25 if nxt is None
                        else min(max(nxt - now, 0.0) + 1e-4, 0.25))
                if not block:
                    return "none", [], [], wait
                cond.wait(wait)

    def _prep_batch(self, st: _Stage, batch: List[_Request],
                    shed: List[_Request]) -> List[_Request]:
        """Post-formation bookkeeping shared by both backends: dedup
        hedged twins, peel off cancelled requests, account the batch
        (log + in-flight), and resolve cancelled/shed branches. Returns
        the servable batch (possibly empty)."""
        batch = self._dedup_batch(st, batch)
        cancelled = [r for r in batch if r.cancelled]
        batch = [r for r in batch if not r.cancelled]
        with st.cond:
            if batch:
                st.batch_log.append((self.now(), len(batch)))
                st.in_flight += len(batch)
        for req in cancelled:       # released by a timed-out driver
            if self._resolve_stage_once(st, req):
                self._finish_branch(st, req)
        for req in shed:
            if self._resolve_stage_once(st, req):
                self._finish_branch(st, req, shed_here=True)
        return batch

    def _complete_batch(self, st: _Stage, batch: List[_Request],
                        t_start: float, outs: List[Any],
                        err: Optional[BaseException],
                        proc_dead: bool) -> bool:
        """Service-completion tail shared by both backends: injected
        straggle/error draws, in-flight/completed accounting, the
        killed-replica requeue, retry routing, and the response scatter
        (:meth:`_on_done` per request). Returns True when the dispatcher
        must exit (its replica was killed mid-service)."""
        cond = st.cond
        spec = self._fault_specs.get(st.name)
        if spec is not None:
            slow = spec.slowdown_at(t_start)
            if slow > 1.0:
                # stretch the observed service time to `slow`x real
                time.sleep(max(0.0,
                               (self.now() - t_start) * (slow - 1.0)))
            if err is None:
                p_err = spec.error_p(t_start)
                if p_err > 0.0:
                    with cond:
                        fail = bool(st.fault_rng.random() < p_err)
                    if fail:
                        err = InjectedFault(
                            f"injected transient error on {st.name}")
        with cond:
            killed = proc_dead
            if not killed and st.kill_pending > 0:
                st.kill_pending -= 1
                killed = True
            st.in_flight -= len(batch)
            if not killed and err is None:
                st.completed += len(batch)
        if killed:
            # the replica died mid-service: its batch is lost and
            # requeues immediately (no backoff — the server failed,
            # not the work); the dispatcher itself exits cleanly
            now = self.now()
            for req in batch:
                self._retry_or_fail(st, req, now, backoff=False)
            return True
        if err is not None:
            # only a recovery policy gets here with an error (without
            # one the dispatcher raised): retry after backoff
            if not isinstance(err, InjectedFault):
                print(f"[executor] stage {st.name} batch failed: {err!r}")
                traceback.print_exception(type(err), err, err.__traceback__)
            now = self.now()
            for req in batch:
                self._retry_or_fail(st, req, now, backoff=True)
            return False
        if len(outs) != len(batch):
            raise ValueError(f"stage {st.name!r} returned {len(outs)} "
                             f"outputs for a batch of {len(batch)}")
        for req, out in zip(batch, outs):
            self._on_done(st, req, out)
        return False

    def _dispatch_loop(self, st: _Stage, t_active: float) -> None:
        """Thread-backend dispatcher: form, serve inline, complete —
        strictly synchronous, one batch at a time."""
        while True:
            verdict, batch, shed, _ = self._formation_step(
                st, t_active, None, block=True)
            if verdict == "exit":
                return
            batch = self._prep_batch(st, batch, shed)
            if not batch:
                continue
            t_start = self.now()
            err: Optional[BaseException] = None
            outs: List[Any] = []
            try:
                outs = st.fn([r.payload for r in batch])
            except Exception as e:  # noqa: BLE001 — retried, or fails the run
                if self._retry is None:
                    raise
                err = e
                outs = [None] * len(batch)
            if self._complete_batch(st, batch, t_start, outs, err, False):
                return

    def _abort_inflight(self, st: _Stage, inflight: "deque") -> None:
        """The paired process died with batches still in the ring:
        none of them reached :meth:`_on_done`, so every request
        requeues immediately — the pipelined arm of the exactly-once
        contract (a SIGKILL mid-handoff loses the slab contents, never
        the requests)."""
        now = self.now()
        while inflight:
            batch, _t = inflight.popleft()
            with st.cond:
                st.in_flight -= len(batch)
            for req in batch:
                self._retry_or_fail(st, req, now, backoff=False)

    def _dispatch_loop_proc(self, st: _Stage, t_active: float,
                            proc: ProcReplica) -> None:
        """Process-backend dispatcher: overlapped dispatch/compute.

        While the ring has free buffers, keep forming batches and
        submitting them (the dispatcher encodes batch B directly into
        the slab while the worker computes on batch A); whenever
        something is in flight, service the oldest response. Formation
        blocks on the condvar only when the ring is empty — with work
        in flight it polls, bounded by the same wait the synchronous
        loop would have slept, so responses are never starved.
        ``ring_depth=1`` (or ``transport="pickle"``) degenerates to the
        strictly synchronous schedule through this same loop."""
        inflight: deque = deque()      # (batch, t_submit) FIFO
        exiting = False
        while True:
            wait_s = 0.25
            while not exiting and proc.free_slots > 0:
                verdict, batch, shed, wait_s = self._formation_step(
                    st, t_active, proc, block=not inflight)
                if verdict == "exit":
                    exiting = True
                    break
                if verdict == "none":
                    break
                batch = self._prep_batch(st, batch, shed)
                if not batch:
                    continue
                t_start = self.now()
                try:
                    proc.submit([r.payload for r in batch])
                except ReplicaDead:
                    self._complete_batch(st, batch, t_start,
                                         [None] * len(batch), None, True)
                    self._abort_inflight(st, inflight)
                    return
                proc.busy = True
                inflight.append((batch, t_start))
            if not inflight:
                if exiting:
                    return
                continue
            # with free ring slots left, poll so newly-ready queue work
            # can overlap the in-flight compute; ring-full (or draining
            # to exit) blocks until the worker responds
            timeout = (min(wait_s, 0.05)
                       if not exiting and proc.free_slots > 0 else None)
            err: Optional[BaseException] = None
            try:
                outs = proc.collect(timeout=timeout)
            except ReplicaDead:
                batch, t_start = inflight.popleft()
                self._complete_batch(st, batch, t_start,
                                     [None] * len(batch), None, True)
                self._abort_inflight(st, inflight)
                return
            except StageWorkerError as e:
                # the stage fn raised inside the worker: the replica
                # survives, the batch failed (retried, or fails the run)
                if self._retry is None:
                    raise
                err = e
                outs = None
            if err is None and outs is None:
                continue                # poll timeout: try forming again
            batch, t_start = inflight.popleft()
            if not inflight:
                proc.busy = False
            if err is not None:
                outs = [None] * len(batch)
            if self._complete_batch(st, batch, t_start, outs, err, False):
                self._abort_inflight(st, inflight)
                return

    # -- request routing ---------------------------------------------------
    def _coin(self, p: float) -> bool:
        if p >= 1.0:
            return True
        with self._rng_lock:
            return bool(self.rng.random() < p)

    def _enqueue(self, stage: str, req: _Request, ready: float) -> bool:
        with self._lock:
            if stage in req.visited:
                return False
            req.visited.add(stage)
            req.pending += 1
        st = self._stages[stage]
        with st.cond:
            st.arrived += 1
            st.queue.push(req, ready, req.deadline)
            # every worker: one notify() can land on a replica still
            # waiting for its activation, which goes back to sleep while
            # the active ones sleep out their timed wait (the reference
            # notifies one and loses the wake-up so)
            st.cond.notify_all()
        return True

    def _resolve_stage_once(self, st: _Stage, req: _Request) -> bool:
        """Claim the single resolution of `req` at this stage (delivery,
        shed, cancel, or retry give-up). Hedged duplicate entries lose
        the claim and must have NO routing or accounting effect."""
        with self._lock:
            if st.name in req.resolved_stages:
                return False
            req.resolved_stages.add(st.name)
            return True

    def _dedup_batch(self, st: _Stage,
                     batch: List[_Request]) -> List[_Request]:
        """Drop hedged-duplicate queue entries: the same request twice
        in one formation, or an entry whose request already resolved at
        this stage (its twin was served or shed earlier)."""
        out: List[_Request] = []
        seen: set = set()
        with self._lock:
            for r in batch:
                if id(r) in seen or st.name in r.resolved_stages:
                    continue
                seen.add(id(r))
                out.append(r)
        return out

    def _retry_or_fail(self, st: _Stage, req: _Request, now: float,
                       backoff: bool) -> None:
        """One failed delivery attempt of `req` at this stage: requeue
        under the recovery policy (exponential backoff for transient
        errors, immediate for crash-aborted work; a hedged duplicate is
        added when the remaining deadline budget is below
        ``hedge_slack_s``), or — retries exhausted / recovery disabled /
        request cancelled — resolve the branch as shed."""
        rec = self._retry
        with self._lock:
            a = req.attempts.get(st.name, 1) + 1
            req.attempts[st.name] = a
            give_up = (rec is None or not rec.enabled
                       or a > int(rec.max_attempts) or req.cancelled)
        if give_up:
            if self._resolve_stage_once(st, req):
                self._finish_branch(st, req, shed_here=True)
            return
        ready = now + (rec.backoff(a - 1) if backoff else 0.0)
        copies = 2 if (rec.hedge_slack_s > 0.0
                       and req.deadline - ready < rec.hedge_slack_s) else 1
        with st.cond:
            for _ in range(copies):
                st.queue.push(req, ready, req.deadline)
            st.cond.notify_all()

    def _route_child(self, stage: str, req: _Request, fired: bool,
                     ready: float) -> None:
        """Deliver one parent message to `stage`'s join barrier: a
        firing token (`fired`, batchable at `ready`) or an anti-token.
        When the last parent message lands, the stage either enqueues
        (>=1 token fired; ready = max over firing parents, the sim's
        AND-join) or relays anti-tokens to its own children."""
        with self._lock:
            got = req.join_msgs.get(stage, 0) + 1
            req.join_msgs[stage] = got
            if fired:
                prev = req.join_ready.get(stage)
                req.join_ready[stage] = (ready if prev is None
                                         else max(prev, ready))
            complete = got == self._parents_n.get(stage, 1)
            fire = complete and stage in req.join_ready
            r = req.join_ready.get(stage, 0.0)
        if not complete:
            return
        if fire:
            self._enqueue(stage, req, r)
        else:
            for e in self._children[stage]:
                self._route_child(e.dst, req, False, 0.0)

    def _finish_branch(self, st: _Stage, req: _Request,
                       shed_here: bool = False) -> None:
        """One branch of the request resolved without outputs (shed,
        cancelled, or retries exhausted). Caller must have won
        :meth:`_resolve_stage_once` for this stage. Children still
        receive their join messages — as anti-tokens — so AND-join
        descendants never stall on a missing parent report."""
        if shed_here:
            req.shed = True
            with st.cond:
                st.dropped += 1
        for e in self._children[st.name]:
            self._route_child(e.dst, req, False, 0.0)
        with self._lock:
            req.pending -= 1
            finished = req.pending == 0
        if finished:
            self._finalize(req)

    def _on_done(self, st: _Stage, req: _Request, out: Any) -> None:
        if not self._resolve_stage_once(st, req):
            return      # hedged twin: the other copy already resolved
        if not req.shed:
            req.payload = out
        ready = self.now() + self.hop_delay_s
        for e in self._children[st.name]:
            fired = (not req.cancelled) and self._coin(e.probability)
            self._route_child(e.dst, req, fired, ready)
        with self._lock:
            req.pending -= 1
            finished = req.pending == 0
        if finished:
            self._finalize(req)

    def _finalize(self, req: _Request) -> None:
        req.t_done = self.now() + self.hop_delay_s   # reply hop
        req.done.set()
        cb = self.on_request_done
        if cb is not None:
            cb(req)

    def inject(self, req: _Request) -> None:
        # the injection guard keeps `pending` positive while entry
        # messages land, so a fast first branch finishing cannot
        # finalize the request before its remaining entry edges route
        with self._lock:
            req.pending += 1
        ready = req.t_arrival + self.hop_delay_s
        for e in self.pipeline.entry_edges():
            self._route_child(e.dst, req, self._coin(e.probability), ready)
        with self._lock:
            req.pending -= 1
            finished = req.pending == 0
            routed = bool(req.visited)
        if finished:
            if routed:
                self._finalize(req)
            else:       # nothing fired anywhere: never entered a queue
                req.t_done = req.t_arrival
                req.done.set()

    def release(self, reqs: List[_Request]) -> int:
        """Cancel every unfinished request in `reqs`: queued occurrences
        are discarded at the next batch formation, in-service batches
        complete but route no further. Returns the number released —
        the timed-out ``serve_trace`` path uses this so stages do not
        keep grinding through a backlog nobody is waiting for."""
        n = 0
        for req in reqs:
            if not req.done.is_set():
                req.cancelled = True
                n += 1
        for st in self._stages.values():
            with st.cond:
                st.cond.notify_all()
        return n

    # -- serving -----------------------------------------------------------
    def release_starved(self) -> int:
        """Release requests stranded at a *dead* stage: replica target 0
        (all replicas crashed, or scaled to zero) with queued work and
        nothing to serve it. The live analogue of the sim's finite
        starvation sentinel — stranded requests resolve promptly
        (reported ``inf``) instead of grinding to the run timeout.
        Hedged duplicates resolve once; AND-join descendants receive
        anti-tokens so the rest of the DAG never stalls. Returns the
        number of requests released."""
        released = 0
        for st in self._stages.values():
            with st.cond:
                if st.target > 0 or st.stop or len(st.queue) == 0:
                    continue
                stranded = st.queue.drain_all()
            for req in stranded:
                if self._resolve_stage_once(st, req):
                    req.cancelled = True
                    released += 1
                    self._finish_branch(st, req)
        return released

    def await_all(self, reqs: List[_Request], timeout_s: float,
                  poll_s: float = 0.2) -> int:
        """Wait until every request in `reqs` resolves, `timeout_s`
        expires or a worker crashes, releasing work stranded on starved
        (zero-replica) stages as soon as the condition is detected — an
        all-dead stage fast-fails in ~`poll_s` rather than eating the
        whole timeout. Returns the number of starvation-released
        requests."""
        deadline_t = time.perf_counter() + float(timeout_s)
        released = 0
        pending = [r for r in reqs if r is not None]
        while True:
            released += self.release_starved()
            pending = [r for r in pending if not r.done.is_set()]
            if not pending or self._failed.is_set():
                return released
            rem = deadline_t - time.perf_counter()
            if rem <= 0.0:
                return released
            pending[0].done.wait(min(poll_s, rem))

    def check_worker_failures(self, context: str = "the run") -> None:
        """Raise if any worker crashed with a real (non-injected)
        exception during `context` — results would silently
        under-serve."""
        with self._lock:
            failures = list(self.worker_failures)
        if failures:
            stages = ", ".join(f"{s}: {e!r}" for s, e in failures)
            raise RuntimeError(
                f"{len(failures)} worker thread(s) crashed during "
                f"{context} ({stages})") from failures[0][1]

    def _note_injection_lags(self, lags: np.ndarray) -> None:
        """Record injection-lag telemetry for the run (how late each
        request was admitted past its nominal absolute deadline)."""
        lags = np.asarray(lags, dtype=np.float64)
        stats = {
            "n": int(lags.size),
            "max_lag_s": float(lags.max()) if lags.size else 0.0,
            "p99_lag_s": (float(np.percentile(lags, 99.0))
                          if lags.size else 0.0),
            "mean_lag_s": float(lags.mean()) if lags.size else 0.0,
        }
        with self._lock:
            self._injection_stats = stats

    def injection_stats(self) -> Optional[Dict[str, float]]:
        """Injection-lag telemetry of the most recent trace injection
        (``serve_trace`` or :class:`~repro_torch.serving.ingress
        .AsyncIngress`): ``{n, max_lag_s, p99_lag_s, mean_lag_s}``, or
        None before the first injection of a run."""
        with self._lock:
            return (dict(self._injection_stats)
                    if self._injection_stats is not None else None)

    def serve_trace(self, arrivals: np.ndarray, payload_fn,
                    timeout_s: float = 300.0,
                    slo_s: Optional[float] = None) -> np.ndarray:
        """Replay `arrivals` (seconds) against the running pipeline;
        returns per-query latency in seconds.

        Open-loop injection is *absolute-deadline* scheduled: payloads
        are pre-built before the clock starts, each sleep targets
        ``start + t_arr`` (never re-anchored on the drifted ``now()``,
        so a late injection catches up instead of compounding), and
        requests are stamped with their NOMINAL arrival — measured
        latency and the ``slo_s`` deadline are charged against the
        intended schedule, not the drifted injection instant. Per-
        request injection lag is recorded (:meth:`injection_stats`).

        Requests still unfinished ``timeout_s`` after the last injection
        are *released* (cancelled and reported as ``inf``), not silently
        abandoned to keep grinding through the stages; requests stranded
        on a stage whose replicas all died release promptly
        (:meth:`release_starved`). ``slo_s`` stamps per-request
        deadlines, which the edf/slo-drop queue policies consume; shed
        requests report ``inf``. A worker crash ends the wait and
        raises. The final payloads are kept for :meth:`outputs`.
        """
        arrivals = np.asarray(arrivals, dtype=np.float64)
        n = int(arrivals.size)
        payloads = [payload_fn(i) for i in range(n)]
        self.start_run()
        reqs: List[_Request] = []
        lags = np.zeros(n, dtype=np.float64)
        for i in range(n):
            t_arr = float(arrivals[i])
            while True:
                dt = t_arr - self.now()
                if dt <= 0.0:
                    break
                time.sleep(dt)
            deadline = t_arr + slo_s if slo_s is not None else float("inf")
            req = _Request(i, t_arr, payloads[i], deadline)
            reqs.append(req)
            self.inject(req)
            lags[i] = self.now() - t_arr
        self._note_injection_lags(lags)
        self.await_all(reqs, timeout_s)
        self.release(reqs)
        self._reqs = reqs
        self.check_worker_failures()
        return np.array([
            np.inf if (r.t_done is None or r.shed or r.cancelled)
            else r.t_done - r.t_arrival
            for r in reqs])

    def outputs(self) -> List[Any]:
        """Final payload of every request of the last ``serve_trace``
        run, in injection order (None for a request that was shed or
        did not finish)."""
        return [r.payload if r.done.is_set() and not (r.cancelled or r.shed)
                else None for r in self._reqs]

    # -- telemetry ---------------------------------------------------------
    def telemetry_counters(self) -> Dict[str, Dict[str, float]]:
        """Instantaneous per-stage counters (cumulative arrived/completed/
        dropped + live queue depth, in-flight, replica target) — the raw
        feed the live control loop turns into ``StageTelemetry`` deltas."""
        out: Dict[str, Dict[str, float]] = {}
        for name, st in self._stages.items():
            with st.cond:
                out[name] = {
                    "arrived": st.arrived,
                    "completed": st.completed,
                    "dropped": st.dropped,
                    "queue_depth": len(st.queue),
                    "in_flight": st.in_flight,
                    "replicas": st.target,
                }
        return out

    def batch_sizes(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for s, st in self._stages.items():
            with st.cond:
                sizes = [b for _, b in st.batch_log]
            out[s] = np.asarray(sizes, dtype=np.int64)
        return out

    def batch_stats(self) -> Dict[str, float]:
        """Mean formed batch size per stage over the current run."""
        return {s: float(v.mean()) if v.size else 0.0
                for s, v in self.batch_sizes().items()}

    def dataplane_stats(self) -> Dict[str, DataplaneStats]:
        """Per-stage transport accounting (process backend; parent-side
        view over the pool lifetime, retired replicas included). Empty
        for the thread backend."""
        out: Dict[str, DataplaneStats] = {}
        for s, st in self._stages.items():
            if st.pool is not None:
                out[s] = st.pool.stats()
        return out

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, join_timeout_s: float = 5.0) -> bool:
        """Stop every worker and join it. Returns True when all worker
        threads exited within the timeout. Safe to call twice."""
        if self._fault_stop is not None:
            self._fault_stop.set()
        to_join: List[threading.Thread] = []
        for st in self._stages.values():
            with st.cond:
                st.stop = True
                st.cond.notify_all()
                to_join.extend(st.workers)
        deadline = time.perf_counter() + join_timeout_s
        for t in to_join:
            t.join(max(0.0, deadline - time.perf_counter()))
        stuck = [t for t in to_join if t.is_alive()]
        if stuck and any(st.pool is not None
                         for st in self._stages.values()):
            # a dispatcher past the join budget is blocked on its worker
            # process (a wedged or slow child): SIGKILL the worker
            # processes — the death sentinel unblocks connection.wait
            # and the dispatcher exits via ReplicaDead
            for st in self._stages.values():
                if st.pool is not None:
                    st.pool.kill(len(st.pool.pids()))
            for t in stuck:
                t.join(2.0)
        ok = all(not t.is_alive() for t in to_join)
        # process backend: dispatchers close their paired replicas on
        # exit; close_all reaps anything left (e.g. a dispatcher stuck
        # past the join budget) so no worker process or slab leaks
        for st in self._stages.values():
            if st.pool is not None:
                st.pool.close_all()
        return ok
