"""Wall-clock pipeline executor of the port: policy-aware centralized
batched queues and replica worker threads serving the port's stages.

A copy of the reference's ``repro/serving/executor.py:
PipelineExecutor``, thread backend. It keeps the three properties
InferLine asks of a serving runtime (§3):

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
  worker threads (optionally activating only after a modeled activation
  delay, like the engine's ``(t, +1)`` events), scale-down *drains* —
  a retiring worker finishes its in-service batch, never abandons it.

Every replica thread of a stage calls the same stage function, so GPU
stages share one copy of their weights; on CUDA each batch takes one of
the stage's replica slots (:mod:`repro_torch.serving.stage`).

Shutdown is condition-variable based: no queue sentinels, so there is
no sentinel/batch-assembly race — ``shutdown()`` joins every worker.

The executor also exposes the control-plane surface the closed-loop
Tuner drives: :meth:`PipelineExecutor.apply_control_event` accepts the
same :class:`repro_torch.control.ControlEvent` s the co-simulation folds,
and :meth:`telemetry_counters` feeds the
:class:`repro_torch.serving.loop.LiveControlLoop` driver that assembles
real :class:`~repro_torch.sim.result.EpochTelemetry` records.

A worker that raises fails the run: the exception is recorded, the
waiting driver wakes, and :meth:`PipelineExecutor.serve_trace` (or the
control loop) raises instead of returning latencies that silently
under-serve.

Not ported yet (ROADMAP A3): fault injection (``faults=``), retries
(``retry=``) and the process backend (``backend="process"``). Each
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.control import ControlEvent
from repro_torch.core.pipeline import Pipeline, PipelineConfig
from repro_torch.core.policy import LiveQueue
from repro_torch.serving.frontends import Frontend

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
    # AND-join barrier: per-stage count of parent messages received and
    # the max readiness over *firing* parents (see _route_child)
    join_msgs: dict = dataclasses.field(default_factory=dict)  # guarded-by: _lock
    join_ready: dict = dataclasses.field(default_factory=dict)  # guarded-by: _lock


class _Stage:
    """One centralized policy queue + its replica worker threads."""

    def __init__(self, name: str, fn: StageFn, max_batch: int, policy: str,
                 solo_latency_s: float, timeout_s: float = 0.0):
        self.name = name
        self.fn = fn
        self.max_batch = max_batch
        self.solo_latency_s = solo_latency_s
        self.queue = LiveQueue(policy, timeout_s=timeout_s)  # guarded-by: cond
        self.cond = threading.Condition()
        self.workers: List[threading.Thread] = []      # guarded-by: cond
        self.target = 0                 # guarded-by: cond (replica target)
        self.retire_pending = 0         # guarded-by: cond
        self.stop = False               # guarded-by: cond
        # cumulative counters (run-relative; reset by start_run)
        self.arrived = 0                # guarded-by: cond
        self.completed = 0              # guarded-by: cond
        self.dropped = 0                # guarded-by: cond
        self.in_flight = 0              # guarded-by: cond
        self.batch_log: List[Tuple[float, int]] = []   # guarded-by: cond


class PipelineExecutor:
    """Deploys a configured pipeline over real worker threads.

    Args:
      pipeline: the DAG; conditional edges are sampled per request from
        ``seed``.
      config: per-stage (hardware*, batch, replicas, policy, timeout) —
        hardware is informational; batch/replicas/policy/timeout are
        enforced.
      stage_fns: model_id -> callable(List[payload]) -> List[payload].
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
      faults, retry, backend: the reference's fault injection, retry
        policy and process backend; only ``None``, ``None`` and
        ``"thread"`` are served (the others raise).

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
                 faults=None,
                 retry=None,
                 backend: str = "thread"):
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown executor backend {backend!r}")
        for what, asked in (("faults=", faults is not None),
                            ("retry=", retry is not None),
                            ('backend="process"', backend == "process")):
            if asked:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP A3: fault "
                    f"injection, retries and the process backend)")
        self.pipeline = pipeline
        self.config = config
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
        # silent replica loss that deadlocks the run
        self.worker_failures: List[Tuple[str, BaseException]] = []  # guarded-by: _lock
        self._failed = threading.Event()
        # injection-lag telemetry of the most recent trace injection
        self._injection_stats: Optional[Dict[str, float]] = None  # guarded-by: _lock
        self._reqs: List[_Request] = []
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
            st = _Stage(name, stage_fns[stage.model_id], cfg.batch_size,
                        cfg.policy, float(solo.get(name, 0.0)),
                        timeout_s=float(cfg.timeout_s))
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
        with activation delay."""
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

    def fault_deltas(self) -> Dict[str, List[Tuple[float, int]]]:
        """Per-stage ``(t, -n)`` capacity losses from injected crashes
        this run — what the live control loop subtracts from the replica
        target to report the ``alive`` telemetry field. Empty until
        fault injection is ported."""
        return {name: [] for name in self._stages}

    def live_worker_count(self, stage: str) -> int:
        """Worker threads actually alive (draining included)."""
        st = self._stages[stage]
        with st.cond:
            st.workers = [t for t in st.workers if t.is_alive()]
            return len(st.workers)

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
        try:
            self._dispatch_loop(st, t_active)
        except Exception as e:  # noqa: BLE001 — a dead replica must fail
            # the run loudly instead of stranding its requests
            self._note_worker_failure(st.name, e)

    def _next_work(self, st: _Stage, t_active: float
                   ) -> Optional[Tuple[List[_Request], List[_Request]]]:
        """Sleep on the stage's condition until a batch and/or a shed set
        forms: ``(batch, shed)``, or None when the worker must wind down
        (shutdown, or a retire drain — the pending count is consumed
        here, between batches, never mid-batch)."""
        cond = st.cond
        with cond:
            while True:
                if st.stop:
                    return None
                if st.retire_pending > 0:
                    st.retire_pending -= 1
                    return None
                now = self.now()
                if now < t_active:
                    cond.wait(min(t_active - now, 0.1))
                    continue
                batch, shed = st.queue.form_batch(
                    now, st.max_batch, st.solo_latency_s)
                if batch or shed:
                    return batch, shed
                nxt = st.queue.next_ready_after(now, st.max_batch)
                cond.wait(0.25 if nxt is None
                          else min(max(nxt - now, 0.0) + 1e-4, 0.25))

    def _prep_batch(self, st: _Stage, batch: List[_Request],
                    shed: List[_Request]) -> List[_Request]:
        """Post-formation bookkeeping: peel off cancelled requests,
        account the batch (log + in-flight), and resolve cancelled/shed
        branches. Returns the servable batch (possibly empty)."""
        cancelled = [r for r in batch if r.cancelled]
        batch = [r for r in batch if not r.cancelled]
        with st.cond:
            if batch:
                st.batch_log.append((self.now(), len(batch)))
                st.in_flight += len(batch)
        for req in cancelled:       # released by a timed-out driver
            self._finish_branch(st, req)
        for req in shed:
            self._finish_branch(st, req, shed_here=True)
        return batch

    def _dispatch_loop(self, st: _Stage, t_active: float) -> None:
        """Form, serve inline, complete — strictly synchronous, one batch
        at a time."""
        while True:
            work = self._next_work(st, t_active)
            if work is None:
                return
            batch = self._prep_batch(st, *work)
            if not batch:
                continue
            outs = st.fn([r.payload for r in batch])
            if len(outs) != len(batch):
                raise ValueError(
                    f"stage {st.name!r} returned {len(outs)} outputs "
                    f"for a batch of {len(batch)}")
            with st.cond:
                st.in_flight -= len(batch)
                st.completed += len(batch)
            for req, out in zip(batch, outs):
                self._on_done(st, req, out)

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
        """One branch of the request resolved without outputs (shed or
        cancelled). Children still receive their join messages — as
        anti-tokens — so AND-join descendants never stall on a missing
        parent report."""
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
        (scaled to zero) with queued work and nothing to serve it. The
        live analogue of the sim's finite starvation sentinel — stranded
        requests resolve promptly (reported ``inf``) instead of grinding
        to the run timeout. AND-join descendants receive anti-tokens so
        the rest of the DAG never stalls. Returns the number of requests
        released."""
        released = 0
        for st in self._stages.values():
            with st.cond:
                if st.target > 0 or st.stop or len(st.queue) == 0:
                    continue
                stranded = st.queue.drain_all()
            for req in stranded:
                req.cancelled = True
                released += 1
                self._finish_branch(st, req)
        return released

    def await_all(self, reqs: List[_Request], timeout_s: float,
                  poll_s: float = 0.2) -> int:
        """Wait until every request in `reqs` resolves, `timeout_s`
        expires or a worker crashes, releasing work stranded on starved
        (zero-replica) stages as soon as the condition is detected.
        Returns the number of starvation-released requests."""
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
        """Raise if any worker thread crashed during `context` — results
        would silently under-serve."""
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
        """Injection-lag telemetry of the most recent trace injection:
        ``{n, max_lag_s, p99_lag_s, mean_lag_s}``, or None before the
        first injection of a run."""
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
        on a stage scaled to zero release promptly
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

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, join_timeout_s: float = 5.0) -> bool:
        """Stop every worker and join it. Returns True when all worker
        threads exited within the timeout. Safe to call twice."""
        to_join: List[threading.Thread] = []
        for st in self._stages.values():
            with st.cond:
                st.stop = True
                st.cond.notify_all()
                to_join.extend(st.workers)
        deadline = time.perf_counter() + join_timeout_s
        for t in to_join:
            t.join(max(0.0, deadline - time.perf_counter()))
        return all(not t.is_alive() for t in to_join)
