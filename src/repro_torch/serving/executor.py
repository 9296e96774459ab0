"""Wall-clock pipeline executor of the port: one centralized batched FIFO
queue per stage and replica worker threads serving the port's stages.

A trimmed copy of the reference's ``repro/serving/executor.py:
PipelineExecutor``, thread backend only. It keeps the three properties
InferLine asks of a serving runtime (§3):

* a **centralized batched queue per stage**, FIFO, with the formation
  hold of ``StageConfig.timeout_s``: a partial batch stays queued until
  ``timeout_s`` past the head-of-line ready instant or until the batch
  fills, whichever comes first;
* the **maximum batch size** of ``StageConfig.batch_size``, enforced at
  formation;
* ``StageConfig.replicas`` **worker threads** per stage, all calling the
  same stage function, so GPU stages share one copy of their weights.

Edges may be conditional (each is sampled per request); every stage has
at most one parent. The EDF and slo-drop policies, AND-joins, control
events, faults, runtime scaling and the process backend arrive with the
control-plane slice.

A worker that raises fails the run: the exception is recorded, the
waiting driver wakes, and :meth:`PipelineExecutor.serve_trace` raises
instead of returning latencies that silently under-serve.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pipeline import Pipeline, PipelineConfig

StageFn = Callable[[List[Any]], List[Any]]


@dataclasses.dataclass
class _Request:
    rid: int
    t_arrival: float                    # executor-clock seconds (nominal)
    payload: Any
    t_done: Optional[float] = None
    cancelled: bool = False             # released by a timed-out driver
    pending: int = 0                    # branches in flight (under _lock)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


class FifoQueue:
    """Centralized FIFO queue with the batch-formation hold.

    Items carry the instant they become batchable. Not thread-safe by
    itself: the executor serializes access under the stage's condition.
    """

    def __init__(self, timeout_s: float = 0.0):
        self.timeout_s = float(timeout_s)
        self._seq = itertools.count()
        self._heap: List[Tuple[float, int, Any]] = []   # (ready, seq, item)

    def __len__(self) -> int:
        return len(self._heap)

    def clear(self) -> None:
        self._heap.clear()

    def push(self, item: Any, ready: float) -> None:
        heapq.heappush(self._heap, (ready, next(self._seq), item))

    def next_ready_after(self, now: float, max_batch: int) -> Optional[float]:
        """Earliest instant a formation could produce a batch after
        ``now`` (None if empty): the head's ready instant, or the end of
        its hold while fewer than ``max_batch`` items are ready."""
        if not self._heap:
            return None
        head = self._heap[0][0]
        if self.timeout_s > 0.0 and head <= now:
            release = head + self.timeout_s
            n_ready = sum(1 for r, _, _ in self._heap if r <= now)
            if release > now and n_ready < max_batch:
                return release
        return max(head, now)

    def form_batch(self, now: float, max_batch: int) -> List[Any]:
        """Pop up to ``max_batch`` ready items in arrival order; empty
        while none is ready or the hold keeps a partial batch open."""
        popped: List[Tuple[float, int, Any]] = []
        while self._heap and len(popped) < max_batch \
                and self._heap[0][0] <= now:
            popped.append(heapq.heappop(self._heap))
        if (popped and self.timeout_s > 0.0 and len(popped) < max_batch
                and now < popped[0][0] + self.timeout_s):
            for entry in popped:
                heapq.heappush(self._heap, entry)
            return []
        return [item for _, _, item in popped]


class _Stage:
    """One centralized queue + its replica worker threads. Every field
    below ``cond`` is read and written under ``cond``."""

    def __init__(self, name: str, fn: StageFn, max_batch: int,
                 timeout_s: float):
        self.name = name
        self.fn = fn
        self.max_batch = max_batch
        self.cond = threading.Condition()
        self.queue = FifoQueue(timeout_s)
        self.workers: List[threading.Thread] = []
        self.stop = False
        self.batch_log: List[Tuple[float, int]] = []    # (t_start, size)


class PipelineExecutor:
    """Deploys a configured pipeline over real worker threads.

    Args:
      pipeline: the DAG (each stage with at most one parent); conditional
        edges are sampled per request from ``seed``.
      config: per-stage ``StageConfig``; ``batch_size``, ``replicas`` and
        ``timeout_s`` are enforced, ``policy`` must be ``"fifo"`` and
        ``hardware`` is informational.
      stage_fns: model_id -> callable(List[payload]) -> List[payload].
    """

    def __init__(self, pipeline: Pipeline, config: PipelineConfig,
                 stage_fns: Dict[str, StageFn], seed: int = 0):
        for name in pipeline.stages:
            if len(pipeline.parents(name)) > 1:
                raise ValueError(
                    f"stage {name!r} has several parents: AND-joins "
                    f"arrive with the control-plane slice")
            if config[name].policy != "fifo":
                raise ValueError(
                    f"stage {name!r}: the port serves the fifo policy "
                    f"only, got {config[name].policy!r}")
        self.pipeline = pipeline
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()      # request routing, rng, failures
        self._children = {s: pipeline.children(s) for s in pipeline.stages}
        self._t0 = time.perf_counter()
        self.worker_failures: List[Tuple[str, BaseException]] = []
        self._failed = threading.Event()
        self._reqs: List[_Request] = []
        self._stages: Dict[str, _Stage] = {}
        for name, stage in pipeline.stages.items():
            cfg = config[name]
            st = _Stage(name, stage_fns[stage.model_id], cfg.batch_size,
                        cfg.timeout_s)
            self._stages[name] = st
            for _ in range(cfg.replicas):
                t = threading.Thread(target=self._worker, args=(st,),
                                     name=f"{name}-replica", daemon=True)
                st.workers.append(t)
                t.start()

    # -- clock -------------------------------------------------------------
    def now(self) -> float:
        """Seconds on the executor clock (zeroed by :meth:`start_run`)."""
        return time.perf_counter() - self._t0

    def start_run(self) -> None:
        """Re-zero the clock, the batch logs and the queues: requests a
        previous run left behind belong to nobody."""
        with self._lock:
            self._t0 = time.perf_counter()
            self.worker_failures = []
            self._failed.clear()
        for st in self._stages.values():
            with st.cond:
                st.batch_log = []
                st.queue.clear()

    # -- workers -----------------------------------------------------------
    def _worker(self, st: _Stage) -> None:
        try:
            while True:
                with st.cond:
                    batch = self._wait_for_batch(st)
                    if batch is None:
                        return
                    st.batch_log.append((self.now(), len(batch)))
                outs = st.fn([r.payload for r in batch])
                if len(outs) != len(batch):
                    raise ValueError(
                        f"stage {st.name!r} returned {len(outs)} outputs "
                        f"for a batch of {len(batch)}")
                for req, out in zip(batch, outs):
                    self._on_done(st, req, out)
        except Exception as e:  # noqa: BLE001 — a dead replica must fail
            # the run loudly instead of stranding its requests
            with self._lock:
                self.worker_failures.append((st.name, e))
            self._failed.set()

    def _wait_for_batch(self, st: _Stage) -> Optional[List[_Request]]:
        """Under ``st.cond``: the next batch, or None on shutdown."""
        while True:
            if st.stop:
                return None
            now = self.now()
            batch = [r for r in st.queue.form_batch(now, st.max_batch)
                     if not r.cancelled]
            if batch:
                return batch
            nxt = st.queue.next_ready_after(now, st.max_batch)
            st.cond.wait(0.25 if nxt is None
                         else min(max(nxt - now, 0.0) + 1e-4, 0.25))

    # -- request routing ---------------------------------------------------
    def _enqueue(self, stage: str, req: _Request, ready: float) -> None:
        with self._lock:
            req.pending += 1
        st = self._stages[stage]
        with st.cond:
            st.queue.push(req, ready)
            st.cond.notify()

    def _route(self, edges, req: _Request, ready: float) -> None:
        for e in edges:
            if e.probability >= 1.0:
                fire = True
            else:
                with self._lock:
                    fire = bool(self._rng.random() < e.probability)
            if fire:
                self._enqueue(e.dst, req, ready)

    def _release_branch(self, req: _Request) -> None:
        with self._lock:
            req.pending -= 1
            finished = req.pending == 0
        if finished:
            req.t_done = self.now()
            req.done.set()

    def _on_done(self, st: _Stage, req: _Request, out: Any) -> None:
        req.payload = out
        if not req.cancelled:
            self._route(self._children[st.name], req, self.now())
        self._release_branch(req)

    def inject(self, req: _Request) -> None:
        # the guard keeps `pending` positive while the entry edges route,
        # so a fast first branch cannot finish the request early
        with self._lock:
            req.pending += 1
        self._route(self.pipeline.entry_edges(), req, req.t_arrival)
        self._release_branch(req)

    # -- serving -----------------------------------------------------------
    def check_worker_failures(self, context: str = "the run") -> None:
        """Raise if any worker thread crashed during ``context``."""
        with self._lock:
            failures = list(self.worker_failures)
        if failures:
            stages = ", ".join(f"{s}: {e!r}" for s, e in failures)
            raise RuntimeError(
                f"{len(failures)} worker thread(s) crashed during "
                f"{context} ({stages})") from failures[0][1]

    def serve_trace(self, arrivals: np.ndarray,
                    payload_fn: Callable[[int], Any],
                    timeout_s: float = 300.0) -> np.ndarray:
        """Replay ``arrivals`` (seconds) open loop; returns per-request
        latency in seconds (``inf`` for a request unfinished
        ``timeout_s`` after the last injection).

        Payloads are built before the clock starts; each injection sleeps
        toward its absolute instant ``start + t_arr`` (never re-anchored
        on a drifted clock), and requests are stamped with their nominal
        arrival, so latency is charged against the intended schedule.
        The final payloads are kept for :meth:`outputs`.
        """
        arrivals = np.asarray(arrivals, dtype=np.float64)
        payloads = [payload_fn(i) for i in range(arrivals.size)]
        self.start_run()
        reqs: List[_Request] = []
        for i, t_arr in enumerate(arrivals.tolist()):
            while True:
                dt = t_arr - self.now()
                if dt <= 0.0:
                    break
                time.sleep(dt)
            req = _Request(i, t_arr, payloads[i])
            reqs.append(req)
            self.inject(req)
        deadline = time.perf_counter() + timeout_s
        for req in reqs:
            while not req.done.is_set() and not self._failed.is_set():
                rem = deadline - time.perf_counter()
                if rem <= 0.0:
                    break
                req.done.wait(min(rem, 0.1))
        for req in reqs:
            if not req.done.is_set():
                req.cancelled = True
        self._reqs = reqs
        self.check_worker_failures()
        return np.array([np.inf if not r.done.is_set() or r.cancelled
                         else r.t_done - r.t_arrival for r in reqs])

    def outputs(self) -> List[Any]:
        """Final payload of every request of the last ``serve_trace``
        run, in injection order (None for a request that did not
        finish)."""
        return [r.payload if r.done.is_set() and not r.cancelled else None
                for r in self._reqs]

    # -- telemetry ---------------------------------------------------------
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
