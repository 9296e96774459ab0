"""Asyncio open-loop ingress: absolute-deadline trace injection. A copy
of the reference's ``repro.serving.ingress``.

The serial ``serve_trace`` injector is one blocking loop — at high
rates, per-request Python overhead between sleeps becomes the arrival
process. This frontend replaces it for open-loop experiments at
10–100x that scale: ``clients`` coroutines share one event loop, each
owning a round-robin substream of the trace and sleeping toward the
*absolute* instant ``start + t_arr`` (a Locust-style open-loop rig —
a late injection catches up on the next arrival instead of compounding
drift). Requests are stamped with their nominal arrival, so measured
latency and deadlines are charged against the intended schedule, and
per-request injection lag is recorded (:class:`IngressStats`, also
mirrored into :meth:`PipelineExecutor.injection_stats`).

The executor's worker threads (or worker processes, with
``backend="process"``) are untouched: coroutines only sleep, build
nothing (payloads are pre-built), and call the thread-safe
:meth:`PipelineExecutor.inject`. Completion is awaited after the whole
trace is in, via the executor's starvation-aware drain.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.executor import PipelineExecutor, _Request

__all__ = ["AsyncIngress", "IngressStats", "PayloadRing"]


class PayloadRing:
    """Reusable pre-registered payload buffers for trace injection.

    A million-query tensor trace cannot materialize a million payloads
    up front; building a fresh array per arrival puts the allocator on
    the injection hot path instead. This ring pre-builds a small pool
    of payload buffers ONCE and hands them out round-robin — an O(1)
    ``payload_fn`` for :meth:`AsyncIngress.serve_trace` with
    ``prebuild=False``. The same buffer objects recur across requests,
    which is exactly what the zero-copy data plane wants: the dispatcher
    encodes them straight into the slab, so no per-request payload
    allocation happens anywhere on the injection path.

    The ring must be deep enough that a buffer is not rewritten by the
    caller while an earlier request still references it; with read-only
    replay traces (the common case) any depth >= 1 is safe because the
    serving stack never mutates request payloads.
    """

    def __init__(self, slots: List[Any]):
        if not slots:
            raise ValueError("PayloadRing needs at least one slot")
        self._slots = slots

    @classmethod
    def filled(cls, build_fn: Callable[[int], Any],
               slots: int = 8) -> "PayloadRing":
        """Pre-build `slots` payloads with ``build_fn(slot_index)``."""
        return cls([build_fn(i) for i in range(int(slots))])

    def __len__(self) -> int:
        return len(self._slots)

    def __call__(self, i: int) -> Any:
        return self._slots[i % len(self._slots)]


@dataclasses.dataclass
class IngressStats:
    """Injection fidelity of one open-loop trace replay."""

    lag_s: np.ndarray           # per-request injection lag (seconds)
    injected: int
    clients: int

    @property
    def max_lag_s(self) -> float:
        return float(self.lag_s.max()) if self.lag_s.size else 0.0

    @property
    def p99_lag_s(self) -> float:
        return (float(np.percentile(self.lag_s, 99.0))
                if self.lag_s.size else 0.0)

    @property
    def mean_lag_s(self) -> float:
        return float(self.lag_s.mean()) if self.lag_s.size else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "injected": int(self.injected),
            "clients": int(self.clients),
            "max_lag_s": self.max_lag_s,
            "p99_lag_s": self.p99_lag_s,
            "mean_lag_s": self.mean_lag_s,
        }


class AsyncIngress:
    """Open-loop asyncio frontend over a :class:`PipelineExecutor`.

    Args:
      executor: the (already constructed) executor to inject into.
      clients: number of concurrent client coroutines the trace is
        round-robined across. More clients = less per-arrival work per
        coroutine; the default comfortably sustains hundreds of qps.
    """

    def __init__(self, executor: PipelineExecutor, clients: int = 64):
        if clients < 1:
            raise ValueError("clients must be >= 1")
        self.executor = executor
        self.clients = int(clients)

    def serve_trace(self, arrivals: np.ndarray, payload_fn,
                    time_scale: float = 1.0,
                    timeout_s: float = 300.0,
                    slo_s: Optional[float] = None,
                    prebuild: bool = True,
                    ) -> Tuple[np.ndarray, IngressStats]:
        """Drop-in for :meth:`PipelineExecutor.serve_trace`, returning
        ``(latencies, IngressStats)``. Semantics match the serial
        injector (nominal-arrival stamps, release-on-timeout, starved-
        stage fast release, worker-failure surfacing) — only the
        injection engine differs. ``prebuild=False`` calls
        ``payload_fn(i)`` at injection time — pair with a
        :class:`PayloadRing` so the fn stays O(1)."""
        ex = self.executor
        arrivals = np.asarray(arrivals, dtype=np.float64) * time_scale
        n = int(arrivals.size)
        payloads = ([payload_fn(i) for i in range(n)] if prebuild
                    else payload_fn)
        deadlines = (arrivals + slo_s * time_scale if slo_s is not None
                     else np.full(n, np.inf))
        reqs: List[Optional[_Request]] = [None] * n
        lags = np.zeros(n, dtype=np.float64)
        ex.start_run()
        asyncio.run(self._drive(arrivals, payloads, deadlines, reqs, lags))
        ex._note_injection_lags(lags)
        stats = IngressStats(lag_s=lags, injected=n,
                             clients=min(self.clients, max(n, 1)))
        live = [r for r in reqs if r is not None]
        ex.await_all(live, timeout_s)
        ex.release(live)
        ex.check_worker_failures("the ingress run")
        lat = np.array([
            np.inf if (r is None or r.t_done is None or r.shed
                       or r.cancelled)
            else (r.t_done - r.t_arrival) / time_scale
            for r in reqs])
        return lat, stats

    async def _drive(self, arrivals: np.ndarray, payloads: Any,
                     deadlines: np.ndarray,
                     reqs: List[Optional[_Request]],
                     lags: np.ndarray) -> None:
        ex = self.executor
        n = int(arrivals.size)
        if n == 0:
            return
        loop = asyncio.get_running_loop()
        # map executor-clock instants onto the event-loop clock once;
        # every client sleeps toward absolute event-loop deadlines
        off = loop.time() - ex.now()
        k = min(self.clients, n)
        # prebuild=True hands a list (index it); prebuild=False hands
        # the payload_fn itself (call it at injection time)
        get = (payloads.__getitem__ if isinstance(payloads, list)
               else payloads)

        async def client(c: int) -> None:
            for i in range(c, n, k):
                target = arrivals[i] + off
                while True:
                    delay = target - loop.time()
                    if delay <= 0.0:
                        break
                    await asyncio.sleep(delay)
                req = _Request(i, float(arrivals[i]), get(i),
                               float(deadlines[i]))
                reqs[i] = req
                ex.inject(req)
                lags[i] = ex.now() - arrivals[i]

        await asyncio.gather(*(client(c) for c in range(k)))
