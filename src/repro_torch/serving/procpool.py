"""Process-backed replica pool: worker OS processes behind the LiveQueue.
A copy of the reference's ``repro.serving.procpool``.

Batch formation stays where it was — dispatcher *threads* inside
:class:`~repro_torch.serving.executor.PipelineExecutor` holding the
per-stage ``LiveQueue`` under its condition variable — but with
``backend="process"`` each dispatcher is paired with a
:class:`ProcReplica`: a worker process that executes the stage fn, fed
through a shared-memory **ring** plus a control pipe. The
``PipelineExecutor`` / ``LiveControlLoop`` / ``ClosedLoopTuner`` and the
fault machinery are unchanged by construction: the queue contract,
retry/hedging, and the AND-join all live parent-side, and an injected
crash SIGKILLs a real OS process (the paired dispatcher observes the
death and requeues every in-flight batch, exactly like the thread
backend's ``kill_pending`` path).

Transport (the zero-copy data plane)
------------------------------------

The slab is split into ``ring_depth`` equal buffers (default 2 —
double-buffered). Each buffer independently follows the ``handoff``
ownership discipline LOCK01 checks: ownership of buffer *i* alternates
between the two endpoints via the pipe messages that name it — whoever
just received a message for buffer *i* owns it until it sends the next
message naming it. With two buffers the dispatcher assembles the next
batch into buffer B **while the worker computes on buffer A** — the
overlapped dispatch/compute path driven by
``PipelineExecutor._dispatch_loop_proc``.

Message vocabulary (pipe payloads are tiny metadata tuples; tensor
bytes only ever travel through the slab)::

    parent -> child   ("run", buf)          batch encoded in buffer buf
                      ("chunk", tag, buf, nbytes, last)   oversize lane
                      ("ack", buf)          chunk flow control
                      ("quit",)
    child -> parent   ("ready",)            spawn handshake
                      ("ok", buf)           response encoded in-place
                      ("err", buf, repr)    stage fn raised; buf returns
                                            (buf None: the worker could
                                            not start)
                      ("chunk"/"ack", ...)  oversize lane, symmetric

* ``transport="ring"`` (default): batches are encoded with the typed
  zero-copy codec (:mod:`repro_torch.serving.dataplane`) — array and
  CPU tensor payloads are written as raw bytes directly into the slab,
  the worker computes on zero-copy views and writes the response *in
  place* into the same buffer. Other payloads ride the in-slab pickle
  fallback lane. A batch larger than one buffer falls back to
  **chunked-slab** transport (pickle bytes streamed through the buffer
  in capacity-sized hops with ``ack`` flow control) — in BOTH
  directions, requests and responses alike.
* ``transport="pickle"``: the legacy lane, kept for A/B comparison —
  whole-batch pickle through a single-buffer slab, with the old
  inline-pipe fallback for oversize messages.

Because the parent may pipeline ``run`` messages while the child is
mid-chunk (and vice versa), both endpoints keep a pending-message
deque: a message that is not the one currently awaited is queued in
arrival order, never dropped.

Differences from the reference, by design
-----------------------------------------

* **Start method.** ``"spawn"`` is the default: CUDA cannot be used in
  a forked child. The worker entrypoint :func:`_worker_main` is
  module-level and the fn travels as an importable reference —
  ``"module:qualname"``, a name registered via
  :func:`register_worker_fn`, or a picklable object (a module-level
  function's ``functools.partial``, a stage spec). ``"fork"`` stays
  available for fns that cannot pickle.
* **Worker start-up and the handshake bound.** A resolved fn object
  with a ``start_worker()`` method is a *factory*: the child calls it
  (to build its stage, load its kernels, capture its graphs) and serves
  the callable it returns. Only then does it say ``ready``, so the
  handshake covers building the stage. Its bound is
  ``DEFAULT_READY_TIMEOUT_S`` (120 s) instead of the reference's 5 s,
  which covers only resolving the fn: a CUDA child imports torch,
  builds its model on its card and captures its graphs first.
  ``ProcReplica.ready_s`` is the measured spawn-to-ready time. A
  factory that raises reports ``("err", None, repr)`` and the parent
  raises :class:`StageWorkerError` (no retry: a build error is not a
  wedge).
* **Card placement.** A fn object with a ``devices`` tuple is placed:
  each new worker goes to the device that holds the fewest live (or
  starting) workers of this pool, lowest index first, and the child
  serves ``fn.placed(device)``. Nothing else chooses a card.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import pickle
import threading
import time
import traceback
from collections import deque
from multiprocessing import connection as mp_conn
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.dataplane import (
    DataplaneStats,
    SlotOverflow,
    decode_batch,
    encode_batch,
)

__all__ = [
    "DEFAULT_SLAB_BYTES",
    "ProcReplica",
    "ProcessReplicaPool",
    "ReplicaDead",
    "StageWorkerError",
    "register_worker_fn",
    "resolve_worker_fn",
]

DEFAULT_SLAB_BYTES = 1 << 22
TRANSPORTS = ("ring", "pickle")
# the spawn handshake's bound: interpreter start, torch import and the
# fn's start_worker() (a full-width CUDA stage builds and captures its
# graphs inside it)
DEFAULT_READY_TIMEOUT_S = 120.0

# Serializes SharedMemory creation + process start across dispatcher
# threads. A fork taken while a sibling spawn holds the multiprocessing
# resource tracker / shm internals mid-operation hands the child a
# permanently locked lock — the child then wedges before its first recv.
# One start at a time keeps our own machinery quiescent at every fork
# point. The child's start-up (the handshake) runs outside the lock.
_SPAWN_LOCK = threading.Lock()


class ReplicaDead(Exception):
    """The worker process died (crash injection, OOM, hard exit) while a
    batch was in flight — the dispatcher requeues and retires."""


class StageWorkerError(Exception):
    """The stage fn raised *inside* the worker process; carries the
    child-side repr. The replica itself is still healthy."""


# -- picklable fn registry (spawn-safe entrypoint) ---------------------------

_WORKER_FNS: Dict[str, Callable] = {}


def register_worker_fn(name: str, fn: Callable) -> Callable:
    """Register `fn` under `name` for :class:`ProcReplica`/pool
    construction by reference. For ``start_method="spawn"`` the fn must
    be importable (module-level) or picklable so the child can resolve
    it; closures are accepted but only work under fork."""
    _WORKER_FNS[name] = fn
    return fn


def resolve_worker_fn(ref: Union[str, Callable]) -> Callable:
    """Resolve a worker-fn reference: a callable or a worker factory
    (an object with ``start_worker()``) passes through; a registered
    name looks up :func:`register_worker_fn`; a ``"module:qualname"``
    spec imports."""
    if callable(ref) or hasattr(ref, "start_worker"):
        return ref
    if ref in _WORKER_FNS:
        return _WORKER_FNS[ref]
    if ":" in ref:
        mod_name, qual = ref.split(":", 1)
        obj = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
        if not callable(obj):
            raise TypeError(f"worker fn spec {ref!r} is not callable")
        return obj
    raise KeyError(f"unknown worker fn reference {ref!r}")


def _import_spec(fn: Callable) -> Optional[str]:
    """``module:qualname`` for a module-level callable, else None."""
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if not mod or not qual or "<" in qual:
        return None
    spec = f"{mod}:{qual}"
    try:
        if resolve_worker_fn(spec) is fn:
            return spec
    except Exception:  # noqa: BLE001 — unimportable => no spec
        pass
    return None


def _fn_ref_for_ctx(fn: Union[str, Callable], ctx) -> Union[str, Callable]:
    """What to hand the child process: under fork, the callable itself
    (inherited); under spawn, prefer an importable spec — a registered
    name is translated so the child need not share our registry — and
    else the object itself, pickled (a ``functools.partial`` of a
    module-level fn, a stage spec)."""
    start = ctx.get_start_method() if hasattr(ctx, "get_start_method") \
        else "fork"
    resolved = resolve_worker_fn(fn)
    if start == "fork":
        return resolved
    spec = _import_spec(resolved)
    if spec is not None:
        return spec
    # last resort: the callable must pickle (Process.start raises
    # loudly otherwise — better than silently serving the wrong fn)
    return resolved


def _scale_payloads(payloads: Sequence, scale=1) -> List:
    """Module-level demo stage fn (importable: spawn tests/benches)."""
    return [p * scale for p in payloads]


def _sleep_scale_payloads(payloads: Sequence, delay_s: float = 0.0,
                          scale=1) -> List:
    """:func:`_scale_payloads` after ``delay_s`` of service time — a
    stand-in stage of known latency (bind it with ``functools.partial``,
    which pickles, for a spawned worker)."""
    time.sleep(delay_s)
    return [p * scale for p in payloads]


# -- the ring channel ---------------------------------------------------------


class _RingChannel:
    """One endpoint of the shared-memory ring + its pipe.

    Buffer ownership is never locked — it alternates between the two
    processes via the pipe protocol, per buffer: whoever just received
    a message naming buffer *i* owns it until it sends the next message
    naming it. LOCK01 enforces this as the ``handoff`` discipline with
    per-buffer guards: the buffers may only be touched from functions
    annotated as protocol participants.
    """

    def __init__(self, shm: shared_memory.SharedMemory, conn,
                 depth: int = 2, transport: str = "ring") -> None:
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}")
        if depth < 1:
            raise ValueError("ring depth must be >= 1")
        self._conn = conn
        self.transport = transport
        self.depth = depth
        per = len(shm.buf) // depth
        if per < 64:
            # even the chunk lane (raw byte windows) needs some room
            raise ValueError(
                f"slab of {len(shm.buf)} B too small for depth {depth}")
        self._bufs = [shm.buf[i * per:(i + 1) * per]   # guarded-by: handoff(_conn, buf=*)
                      for i in range(depth)]
        # uint8 aliases of the buffers, for overlap (self-alias) checks
        self._guards = [np.frombuffer(b, dtype=np.uint8)  # guarded-by: handoff(_conn, buf=*)
                        for b in self._bufs]
        self._pend: deque = deque()    # out-of-turn messages, FIFO
        self.stats = DataplaneStats()

    # -- raw pipe layer ----------------------------------------------------
    def _recv_raw(self, sentinel=None, timeout=None):  # holds-lock: handoff(_conn, buf=*)
        """One pipe message; with `sentinel` (a process sentinel fd),
        raise :class:`ReplicaDead` if the peer dies first. `timeout`
        returns None on expiry when `sentinel` is None, and raises
        ReplicaDead with a sentinel (an alive-but-silent peer past the
        bound is wedged — the spawn-handshake case)."""
        if sentinel is not None:
            while True:
                ready = mp_conn.wait([self._conn, sentinel],
                                     timeout=timeout)
                if self._conn in ready:
                    break
                if not ready:
                    raise ReplicaDead(
                        "worker process unresponsive within timeout")
                # the process died — drain any final message it managed
                # to flush before declaring the replica dead
                if not self._conn.poll(0.05):
                    raise ReplicaDead("worker process died mid-batch")
        elif timeout is not None:
            if not self._conn.poll(timeout):
                return None
        try:
            return self._conn.recv()
        except (EOFError, OSError) as exc:
            raise ReplicaDead("worker pipe closed") from exc

    def _recv_match(self, want: Tuple[str, ...], sentinel=None,
                    timeout=None):  # holds-lock: handoff(_conn, buf=*)
        """Next message whose tag is in `want`; anything else (a
        pipelined ``run``/``ok`` arriving while we await an ``ack``) is
        queued in arrival order. Returns None on poll timeout."""
        for i, msg in enumerate(self._pend):
            if msg[0] in want:
                del self._pend[i]
                return msg
        while True:
            msg = self._recv_raw(sentinel=sentinel, timeout=timeout)
            if msg is None:
                return None
            if msg[0] in want:
                return msg
            self._pend.append(msg)

    def poll(self, timeout: float, want: Tuple[str, ...]) -> bool:  # holds-lock: handoff(_conn, buf=*)
        """True if a `want` message is available (pending or arriving
        within `timeout`); non-matching arrivals are queued."""
        if any(m[0] in want for m in self._pend):
            return True
        while True:
            if not self._conn.poll(timeout):
                return False
            try:
                msg = self._conn.recv()
            except (EOFError, OSError) as exc:
                raise ReplicaDead("worker pipe closed") from exc
            if msg[0] in want:
                self._pend.appendleft(msg)
                return True
            self._pend.append(msg)
            timeout = 0.0

    def send_ctl(self, *msg) -> None:  # holds-lock: handoff(_conn, buf=*)
        self._conn.send(msg)

    # -- batch transport ---------------------------------------------------
    def send_batch(self, tag: str, buf: int, payloads: Sequence,
                   sentinel=None) -> None:  # holds-lock: handoff(_conn, buf=*)
        """Encode one batch into buffer `buf` (which this endpoint must
        own) and hand ownership to the peer. Oversize batches fall back
        to the chunked-slab lane (``transport="ring"``) or the legacy
        inline pipe (``transport="pickle"``) — both directions use the
        same fallback, requests and responses alike."""
        slot = self._bufs[buf]
        try:
            encode_batch(slot, payloads, self.stats,
                         typed=self.transport == "ring",
                         guard=self._guards[buf])
            self._conn.send((tag, buf))
            return
        except SlotOverflow as ov:
            data = ov.data if ov.data is not None else pickle.dumps(
                payloads, protocol=pickle.HIGHEST_PROTOCOL)
        if self.transport == "pickle":
            self.stats.inline_messages += 1
            self.stats.pickle_bytes += len(data)
            self._conn.send(("inline", tag, buf, data))
            return
        self.stats.pickle_bytes += len(data)
        cap = len(slot)
        n = len(data)
        sent = 0
        while True:
            k = min(cap, n - sent)
            slot[:k] = data[sent:sent + k]
            self.stats.bytes_copied += k
            self.stats.chunk_messages += 1
            sent += k
            last = sent >= n
            self._conn.send(("chunk", tag, buf, k, last))
            if last:
                return
            # flow control: the peer owns the buffer until it copied
            # the chunk out and acked it back
            if self._recv_match(("ack",), sentinel=sentinel) is None:
                raise ReplicaDead("peer vanished mid-chunk")

    def _recv_chunked(self, first, sentinel=None):  # holds-lock: handoff(_conn, buf=*)
        """Reassemble a chunked message starting at `first`; returns
        ``(tag, buf, obj)``. Ownership of `buf` lands on this endpoint
        once the last chunk is copied out."""
        _, tag, buf, k, last = first
        slot = self._bufs[buf]
        parts = bytearray()
        while True:
            parts += slot[:k]
            self.stats.bytes_copied += k
            self.stats.chunk_messages += 1
            if last:
                break
            self._conn.send(("ack", buf))
            nxt = self._recv_match(("chunk",), sentinel=sentinel)
            _, tag, buf, k, last = nxt
        self.stats.pickle_bytes += len(parts)
        return tag, buf, pickle.loads(bytes(parts))

    def recv_batch(self, want: Tuple[str, ...], sentinel=None,
                   timeout=None, copy: bool = False):  # holds-lock: handoff(_conn, buf=*)
        """Receive the next batch-level message whose (reassembled) tag
        is in `want`. Returns ``(tag, buf, obj)`` — `buf`/`obj` are None
        for control messages — or None on poll timeout. ``copy``
        selects owned arrays (dispatcher side) vs zero-copy slot views
        (worker side)."""
        tags = tuple(want) + ("chunk", "inline")
        msg = self._recv_match(tags, sentinel=sentinel, timeout=timeout)
        if msg is None:
            return None
        if msg[0] == "chunk":
            return self._recv_chunked(msg, sentinel=sentinel)
        if msg[0] == "inline":
            _, tag, buf, data = msg
            self.stats.inline_messages += 1
            self.stats.pickle_bytes += len(data)
            return tag, buf, pickle.loads(data)
        tag = msg[0]
        if tag in ("run", "ok"):
            buf = msg[1]
            return tag, buf, decode_batch(self._bufs[buf], copy=copy,
                                          stats=self.stats)
        if tag == "err":
            return tag, msg[1], msg[2]
        return tag, None, None          # ready / quit

    def close(self) -> None:           # holds-lock: handoff(_conn, buf=*)
        """Relinquish this endpoint: drop the slab views, close the
        pipe. Views must be released before the SharedMemory segment
        can close (exported-pointer guard)."""
        self._guards = []
        self._bufs = []
        self._pend.clear()
        try:
            self._conn.close()
        except OSError:
            pass


# -- worker-process entrypoint ------------------------------------------------


def _worker_main(shm_name: str, conn, peer_conn,
                 fn_ref: Union[str, Callable], transport: str = "ring",
                 depth: int = 2) -> None:
    """Module-level worker entrypoint (spawn-safe): serve run requests
    until quit/EOF. `fn_ref` is a callable (fork) or an importable or
    pickled reference resolved here (spawn). A resolved object with a
    ``start_worker()`` method is a factory: the callable it returns is
    what serves, and it is built before the ``ready`` handshake."""
    if peer_conn is not None:
        try:
            peer_conn.close()          # drop the inherited parent end
        except OSError:
            pass
    fn = resolve_worker_fn(fn_ref)
    # NOTE on the resource tracker: this attach re-registers the
    # segment, but both fork and spawn children share the PARENT's
    # tracker process (spawn passes tracker_fd through preparation
    # data), where the re-register is a set-dup no-op — the parent's
    # unlink in ProcReplica.close() stays the single cleanup point.
    # Do NOT unregister here: that would strip the shared cache entry.
    shm = shared_memory.SharedMemory(name=shm_name)
    chan = _RingChannel(shm, conn, depth=depth, transport=transport)
    try:
        start = getattr(fn, "start_worker", None)
        if start is not None:
            # build what this worker serves (a stage on its card, its
            # kernels, its graphs) before saying ready, so the handshake
            # bound covers it; a build error goes back as an err
            try:
                fn = start()
            except Exception as exc:  # noqa: BLE001 — report, then exit
                try:
                    chan.send_ctl("err", None,
                                  f"{type(exc).__name__}: {exc}\n"
                                  f"{traceback.format_exc()}")
                except (OSError, ReplicaDead):
                    pass
                return
        # fork-safety handshake: forking a thread-heavy parent (e.g.
        # once JAX has warmed its internal pools) can deadlock the child
        # on a lock some unforked thread held. Announcing readiness
        # exercises the allocator + pipe path first thing, so a wedged
        # child is detected at spawn instead of eating a batch
        try:
            chan.send_ctl("ready")
        except (OSError, ReplicaDead):
            return
        while True:
            try:
                msg = chan.recv_batch(("run", "quit"), copy=False)
            except ReplicaDead:        # parent closed its end
                break
            tag, buf, payloads = msg
            if tag == "quit":
                break
            try:
                outs = list(fn(payloads))
            except BaseException as exc:  # noqa: BLE001 — report, keep serving
                try:
                    chan.send_ctl("err", buf,
                                  f"{type(exc).__name__}: {exc}")
                except (OSError, ReplicaDead):
                    break
                continue
            try:
                # respond in place: the response overwrites the request
                # buffer we own; outputs aliasing it (echoed input
                # views) are copy-guarded inside the encoder
                chan.send_batch("ok", buf, outs)
            except (OSError, ReplicaDead):
                break
    finally:
        chan.close()
        try:
            shm.close()
        except BufferError:            # a stage fn leaked a slot view
            pass


class ProcReplica:
    """One worker process + its shared-memory ring. Owned by a single
    dispatcher thread (the only caller of :meth:`submit`/:meth:`collect`
    /:meth:`run`/:meth:`close`); :meth:`kill` may be called concurrently
    by the fault driver / control plane.

    The ring pipelines up to ``ring_depth`` batches: :meth:`submit`
    encodes into a free buffer and hands it to the worker without
    waiting; :meth:`collect` blocks for (or polls) the oldest
    outstanding response. :meth:`run` is the synchronous convenience
    wrapper (submit + collect) used by tests and profiling.
    """

    def __init__(self, fn: Union[str, Callable],
                 slab_bytes: int = DEFAULT_SLAB_BYTES, ctx=None,
                 ready_timeout_s: float = DEFAULT_READY_TIMEOUT_S,
                 transport: str = "ring",
                 ring_depth: int = 2,
                 device: Optional[str] = None) -> None:
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}")
        ctx = ctx or mp.get_context("spawn")
        self.device = device           # the card it was placed on, if any
        depth = 1 if transport == "pickle" else max(1, int(ring_depth))
        self.transport = transport
        self.depth = depth
        fn_ref = _fn_ref_for_ctx(fn, ctx)
        t_spawn = time.perf_counter()
        with _SPAWN_LOCK:
            self._shm = shared_memory.SharedMemory(create=True,
                                                   size=int(slab_bytes))
            parent_end, child_end = ctx.Pipe()
            self._chan = _RingChannel(self._shm, parent_end, depth=depth,
                                      transport=transport)
            self._proc = ctx.Process(
                target=_worker_main,
                args=(self._shm.name, child_end, parent_end, fn_ref,
                      transport, depth),
                daemon=True)
            self._proc.start()
        child_end.close()              # child's end lives in the child now
        self._free: deque = deque(range(depth))
        self._inflight: deque = deque()
        self._close_once = threading.Lock()
        self._closed = False           # guarded-by: _close_once
        self.busy = False              # crash-victim hint; racy by design
        # consume the child's ready handshake within a bound: a child
        # that never says ready is wedged (fork of a multithreaded
        # parent) or stuck building — reap it here so it can never join
        # the fleet. A child whose start-up raised says so (err).
        try:
            msg = self._chan.recv_batch(
                ("ready", "err"), sentinel=self._proc.sentinel,
                timeout=ready_timeout_s)
        except ReplicaDead:
            msg = None
        # spawn to ready: process start, imports, the fn's start-up
        self.ready_s = time.perf_counter() - t_spawn
        if msg is not None and msg[0] == "err":
            self.close()
            raise StageWorkerError(
                f"worker process failed to start: {msg[2]}")
        if msg is None or msg[0] != "ready":
            self.close()
            raise ReplicaDead(
                f"worker process failed the spawn handshake within "
                f"{ready_timeout_s:g} s")

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    def alive(self) -> bool:
        return self._proc.is_alive()

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def transport_stats(self) -> DataplaneStats:
        return self._chan.stats

    def submit(self, payloads: Sequence) -> int:
        """Encode one batch into a free ring buffer and hand it to the
        worker without waiting for the result. Returns the buffer index.
        Raises :class:`ReplicaDead` if the process is gone and
        ``RuntimeError`` if no buffer is free (caller must
        :meth:`collect` first)."""
        if not self._free:
            raise RuntimeError("ring full: collect before submitting")
        if not self._proc.is_alive():
            raise ReplicaDead("worker process already dead")
        buf = self._free[0]
        try:
            self._chan.send_batch("run", buf, list(payloads),
                                  sentinel=self._proc.sentinel)
        except (BrokenPipeError, OSError) as exc:
            raise ReplicaDead("worker pipe broken on send") from exc
        self._free.popleft()
        self._inflight.append(buf)
        return buf

    def collect(self, timeout: Optional[float] = None) -> Optional[List]:
        """Receive the oldest outstanding response. Returns the output
        list, or None if `timeout` elapses with no response yet.

        Raises :class:`ReplicaDead` if the process dies under the batch
        (the caller requeues, mirroring the thread backend's killed
        path) and :class:`StageWorkerError` for child-side fn errors.
        """
        if not self._inflight:
            raise RuntimeError("nothing in flight to collect")
        if timeout is not None:
            if not self._chan.poll(timeout, ("ok", "err", "chunk",
                                             "inline")):
                if not self._proc.is_alive():
                    raise ReplicaDead("worker process died mid-batch")
                return None
        msg = self._chan.recv_batch(("ok", "err"),
                                    sentinel=self._proc.sentinel,
                                    copy=True)
        tag, buf, obj = msg
        expected = self._inflight.popleft()
        self._free.append(buf if buf is not None else expected)
        if tag == "ok":
            return obj
        raise StageWorkerError(obj)

    def run(self, payloads: Sequence) -> List:
        """Execute one batch synchronously (submit + collect)."""
        while self._inflight:          # drain any pipelined stragglers
            self.collect()
        self.submit(payloads)
        out = self.collect()
        assert out is not None
        return out

    def kill(self) -> None:
        """SIGKILL the worker — the injected-crash path. A real OS
        process dies; any in-flight batch surfaces as ReplicaDead in
        the paired dispatcher."""
        if self._proc.is_alive():
            self._proc.kill()

    def close(self) -> None:
        """Graceful retire: ask the child to quit, reap it, free the
        slab. Idempotent and safe to race (dispatcher exit vs pool
        shutdown)."""
        with self._close_once:
            if self._closed:
                return
            self._closed = True
        try:
            if self._proc.is_alive():
                self._chan.send_ctl("quit")
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(timeout=2.0)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=2.0)
        self._chan.close()
        self._shm.close()
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


class ProcessReplicaPool:
    """Per-stage registry of live :class:`ProcReplica` workers.

    The executor's dispatcher threads spawn/close members through this
    pool; the fault driver calls :meth:`kill` to take down real
    processes at scheduled instants (busy victims first, so crash
    injection exercises the in-flight requeue path whenever possible,
    matching the thread backend's semantics where only a dispatching
    worker could consume a kill). Transport stats of retired members
    accumulate so :meth:`stats` reports the whole pool lifetime.
    """

    def __init__(self, fn: Union[str, Callable],
                 slab_bytes: int = DEFAULT_SLAB_BYTES,
                 start_method: str = "spawn",
                 transport: str = "ring",
                 ring_depth: int = 2) -> None:
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}")
        self._fn = fn
        # placement reads the resolved object's `devices` (a stage spec)
        self._devices: Tuple[str, ...] = tuple(
            getattr(resolve_worker_fn(fn), "devices", None) or ())
        self._slab_bytes = int(slab_bytes)
        self._ctx = mp.get_context(start_method)
        self._transport = transport
        self._ring_depth = int(ring_depth)
        self._plock = threading.Lock()
        self._members: List[ProcReplica] = []   # guarded-by: _plock
        self._placing: List[str] = []           # guarded-by: _plock
        self._retired_stats = DataplaneStats()  # guarded-by: _plock
        self._closed = False                    # guarded-by: _plock
        # (pid, device, spawn-to-ready seconds) of every worker started
        self._spawns: List[Tuple[int, Optional[str], float]] = []  # guarded-by: _plock
        self._killed: List[int] = []            # guarded-by: _plock

    def _place(self) -> Optional[str]:
        """The device for the next worker: the one holding the fewest
        live or starting workers of this pool, lowest index first (None
        for a fn that names no devices). Reserved until the worker
        joins the pool or fails to start."""
        if not self._devices:
            return None
        with self._plock:
            load = {d: 0 for d in self._devices}
            for d in self._placing:
                load[d] += 1
            for m in self._members:
                if m.device in load and m.alive():
                    load[m.device] += 1
            dev = min(self._devices,
                      key=lambda d: (load[d], self._devices.index(d)))
            self._placing.append(dev)
        return dev

    def spawn(self) -> ProcReplica:
        device = self._place()
        fn = (resolve_worker_fn(self._fn).placed(device)
              if device is not None else self._fn)
        # a wedged fork is retryable; a spawned child is not forked from
        # this process's threads, so its failure is reported at once
        attempts = 3 if self._ctx.get_start_method() == "fork" else 1
        last: Optional[ReplicaDead] = None
        try:
            for _ in range(attempts):
                try:
                    rep = ProcReplica(fn, self._slab_bytes, self._ctx,
                                      transport=self._transport,
                                      ring_depth=self._ring_depth,
                                      device=device)
                except ReplicaDead as exc:
                    last = exc
                    continue
                with self._plock:
                    closed = self._closed
                    if not closed:
                        self._members.append(rep)
                        self._spawns.append((rep.pid, device, rep.ready_s))
                    if device is not None:
                        self._placing.remove(device)
                        device = None
                if closed:
                    # the pool shut down while this worker started
                    rep.close()
                    raise RuntimeError("the pool was closed while a "
                                       "worker process started")
                return rep
        finally:
            if device is not None:
                with self._plock:
                    self._placing.remove(device)
        raise RuntimeError(
            f"could not spawn a healthy worker process: {last}")

    def discard(self, rep: ProcReplica) -> None:
        """Forget a member (dispatcher exit path); caller closes it.
        Its transport stats roll into the pool accumulator."""
        with self._plock:
            if rep in self._members:
                self._members.remove(rep)
                self._retired_stats.add(rep.transport_stats())

    def kill(self, n: int) -> int:
        """SIGKILL up to ``n`` live members, busy ones first. Returns
        the number actually signalled."""
        with self._plock:
            live = [m for m in self._members if m.alive()]
            victims = sorted(live, key=lambda m: not m.busy)[: max(0, n)]
            self._killed.extend(v.pid for v in victims)
        for v in victims:
            v.kill()
        return len(victims)

    def alive_count(self) -> int:
        with self._plock:
            return sum(1 for m in self._members if m.alive())

    def pids(self) -> List[int]:
        with self._plock:
            return [m.pid for m in self._members if m.alive()]

    def devices(self) -> List[Optional[str]]:
        """The device of each live member (None where unplaced)."""
        with self._plock:
            return [m.device for m in self._members if m.alive()]

    def spawn_log(self) -> List[Tuple[int, Optional[str], float]]:
        """``(pid, device, spawn-to-ready seconds)`` of every worker this
        pool started, in the order they became ready."""
        with self._plock:
            return list(self._spawns)

    def killed_pids(self) -> List[int]:
        """The pids :meth:`kill` signalled, in order."""
        with self._plock:
            return list(self._killed)

    def stats(self) -> DataplaneStats:
        """Pool-lifetime transport accounting: live members + retired."""
        out = DataplaneStats()
        with self._plock:
            out.add(self._retired_stats)
            for m in self._members:
                out.add(m.transport_stats())
        return out

    def close_all(self) -> None:
        """Close every member; a worker still starting is closed when it
        is ready (:meth:`spawn` raises then)."""
        with self._plock:
            self._closed = True
            members, self._members = self._members, []
            for m in members:
                self._retired_stats.add(m.transport_stats())
        for m in members:
            m.close()
