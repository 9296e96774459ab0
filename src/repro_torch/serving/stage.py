"""The served cascade's stage: one model scoring token windows.

The counterpart of ``make_stage`` in ``examples/serve_real_models.py``:
a stage scores a batch of ``(SEQ,)`` int32 token windows with
``Model.forward`` and answers each with the window shifted by one, the
argmax of the last position appended, so the next stage of the cascade
receives the same shape. Batches are padded up to a power-of-two bucket.

On CUDA a batch is one CUDA graph replay, the port's counterpart of the
reference's one ``jax.jit`` call per batch. ``warmup`` runs ``score``
eagerly once per bucket up to ``max_batch`` on a slot's own stream (the
first call of each kernel sets its attributes, cuBLAS settles its
kernels), then captures one ``torch.cuda.CUDAGraph`` per bucket, each
with its own memory pool, a static ``(b, SEQ)`` int32 token buffer, and
the logits and the answer as its static outputs. Call it before the
executor starts: a capture fails while another thread uses the card, so
nothing is ever captured from a worker thread. A capture that fails
raises, and so does a batch whose bucket was not captured: there is no
eager fallback on CUDA.

The graphs come in **replica slots**. ``warmup(max_batch, slots=N)``
captures N independent sets of the buckets, each set with its own static
buffers, pinned host buffers and stream; the weights are the stage's,
shared by all. ``run_batch`` and ``profile_fn`` take any free slot (the
lowest free one) for the whole of copy-in, replay and copy-out, and
wait while every slot is busy, so replica threads of one stage replay at
once on as many streams as there are slots. With one slot, replicas
take turns. A replay runs no Python wrapper, so each bucket records how
many launches of each kernel its capture counted and adds them to the
kernels' counters at every replay.

On the CPU the stage runs ``score`` eagerly and captures nothing.

:class:`ProcessStage` is the same stage for a worker process of the
process backend (:mod:`repro_torch.serving.procpool`): a picklable spec
from which a spawned child builds, on its own card and from the same
seed, the stage ``make_stage`` builds, warms one slot, and serves
``run_batch``. A closure such as ``run_batch`` cannot reach a spawned
child except by pickling, which it does not survive.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from pathlib import Path
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Tuple, Union)

import numpy as np
import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.core.planner import MAX_BATCH
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention, flash_attention, \
    mamba_scan, rmsnorm
from repro_torch.models import Model, build_model
from repro_torch.models.config import ArchConfig

SEQ = 32
COUNTERS = tuple(m.counter for m in (rmsnorm, flash_attention,
                                     decode_attention, mamba_scan))


@dataclasses.dataclass
class GraphBucket:
    """One captured batch shape of a slot on CUDA: the graph, its static
    tensors on the card, pinned host buffers for the copies, and the
    launches one replay makes. Its slot's holder owns all of them."""
    graph: torch.cuda.CUDAGraph
    tokens: torch.Tensor          # (b, SEQ) int32, the graph's input
    logits: torch.Tensor          # (b, SEQ, vocab) f32
    out: torch.Tensor             # (b, SEQ) int32, the answer
    host_in: torch.Tensor
    host_out: torch.Tensor
    launches: Tuple[Tuple[_build.LaunchCounter, int], ...]


@dataclasses.dataclass
class Slot:
    """One replica slot of a stage on CUDA: a captured bucket per batch
    shape and the stream its replays run on."""
    stream: torch.cuda.Stream
    graphs: Dict[int, GraphBucket]


class SlotPool:
    """A stage's replica slots and which of them are free. ``slots``
    changes only while no replica serves: it grows in ``warmup`` and
    shrinks in ``keep``."""

    def __init__(self) -> None:
        self.slots: List[Slot] = []
        self._cond = threading.Condition()
        self._free: List[int] = []     # guarded-by: _cond

    def add(self, slot: Slot) -> None:
        with self._cond:
            self.slots.append(slot)
            self._free.append(len(self.slots) - 1)
            self._cond.notify()

    def keep(self, n: int) -> None:
        """Drop every slot past the first ``n`` (their graphs and
        buffers go with them). Only while no replica serves: raises if
        one of them is taken."""
        with self._cond:
            extra = set(range(n, len(self.slots)))
            if not extra <= set(self._free):
                raise RuntimeError("a slot to drop is in use")
            del self.slots[n:]
            self._free = [i for i in self._free if i < n]

    @contextlib.contextmanager
    def take(self) -> Iterator[Slot]:
        """Hold the lowest free slot for the ``with`` block; wait while
        every slot is busy."""
        with self._cond:
            while not self._free:
                self._cond.wait()
            i = min(self._free)
            self._free.remove(i)
        try:
            yield self.slots[i]
        finally:
            with self._cond:
                self._free.append(i)
                self._cond.notify()


class ServedStage(NamedTuple):
    cfg: ArchConfig
    model: Model
    params: Dict[str, Any]
    run_batch: Callable[[List[Any]], List[np.ndarray]]
    profile_fn: Callable[[int], None]
    warmup: Callable[..., None]
    graphs: Dict[int, GraphBucket]         # slot 0's, by bucket; CPU: empty
    stream: Optional[torch.cuda.Stream]    # slot 0's; CPU: None
    pool: SlotPool                         # every slot; CPU: none


def _bucket(n: int) -> int:
    """Next power of two >= n: a fixed set of batch shapes."""
    b = 1
    while b < n:
        b *= 2
    return b


def make_stage(arch_id: str,
               device: Optional[Union[str, torch.device]] = None,
               full: bool = True, seed: int = 0) -> ServedStage:
    """Build ``arch_id`` at its published widths (``full=False``: the
    smoke variant) with seeded random parameters on ``device`` (default
    ``cuda``) and return its batch scoring functions. On CUDA, call
    ``warmup`` before serving: it captures the graphs, in as many replica
    slots as it is asked for."""
    cfg = get_arch(arch_id) if full else get_smoke(arch_id)
    model = build_model(cfg, device)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)
    cuda = dev.type == "cuda"
    pool = SlotPool()
    if cuda:
        pool.add(Slot(torch.cuda.Stream(dev), {}))

    @torch.inference_mode()
    def score(tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, _ = model.forward(params, {"tokens": tokens})
        nxt = logits[:, -1].argmax(dim=-1).to(tokens.dtype)
        return logits, torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)

    def capture(b: int, stream: torch.cuda.Stream) -> GraphBucket:
        tokens = torch.ones((b, SEQ), dtype=torch.int32, device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            score(tokens)                   # eager, before the capture
        stream.synchronize()
        before = [c.count for c in COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            logits, out = score(tokens)
        launches = tuple((c, c.count - n) for c, n in zip(COUNTERS, before)
                         if c.count > n)
        return GraphBucket(graph, tokens, logits, out,
                           torch.empty((b, SEQ), dtype=torch.int32,
                                       pin_memory=True),
                           torch.empty((b, SEQ), dtype=torch.int32,
                                       pin_memory=True), launches)

    @torch.inference_mode()
    def replay(rows: np.ndarray) -> np.ndarray:
        b = _bucket(len(rows))
        if b not in pool.slots[0].graphs:
            raise RuntimeError(
                f"{arch_id}: no CUDA graph for a batch of {b}; warmup("
                f"max_batch >= {b}) captures one per bucket before serving")
        with pool.take() as slot:
            bucket = slot.graphs[b]
            host = bucket.host_in.numpy()
            host[:len(rows)] = rows
            host[len(rows):] = 0
            with torch.cuda.stream(slot.stream):
                bucket.tokens.copy_(bucket.host_in, non_blocking=True)
                bucket.graph.replay()
                bucket.host_out.copy_(bucket.out, non_blocking=True)
            for counter, k in bucket.launches:
                counter.add_many(k)
            slot.stream.synchronize()
            return bucket.host_out.numpy()[:len(rows)].copy()

    def run_batch(payloads: List[Any]) -> List[np.ndarray]:
        rows = np.stack([np.asarray(p, dtype=np.int32) for p in payloads])
        if cuda:
            return list(replay(rows))
        # pad to a power-of-two bucket: the same few shapes every time
        tokens = np.zeros((_bucket(len(rows)), SEQ), dtype=np.int32)
        tokens[:len(rows)] = rows
        out = score(torch.from_numpy(tokens))[1].numpy()
        return list(out[:len(rows)])

    def profile_fn(b: int) -> None:
        if cuda:
            replay(np.ones((b, SEQ), dtype=np.int32))
        else:
            score(torch.ones((b, SEQ), dtype=torch.int32))

    def fill(slot: Slot, max_batch: int) -> Slot:
        b = 1
        while b <= max_batch:
            if b not in slot.graphs:
                slot.graphs[b] = capture(b, slot.stream)
            b *= 2
        return slot

    def warmup(max_batch: int = MAX_BATCH, slots: int = 1) -> None:
        """CUDA: capture every bucket up to ``max_batch`` in each of at
        least ``slots`` slots, before any replica serves. CPU: run each
        bucket once."""
        if not cuda:
            b = 1
            while b <= max_batch:
                profile_fn(b)
                b *= 2
            return
        for slot in pool.slots:
            fill(slot, max_batch)
        while len(pool.slots) < slots:
            pool.add(fill(Slot(torch.cuda.Stream(dev), {}), max_batch))

    slot0 = pool.slots[0] if cuda else None
    return ServedStage(cfg, model, params, run_batch, profile_fn, warmup,
                       slot0.graphs if cuda else {},
                       slot0.stream if cuda else None, pool)


COUNT_FIELDS = ("batches",) + tuple(
    m.__name__.rsplit(".", 1)[-1] for m in (rmsnorm, flash_attention,
                                             decode_attention, mamba_scan))


@dataclasses.dataclass(frozen=True)
class ProcessStage:
    """The served stage as a worker process builds it (the process
    backend's stage fn): picklable, so a spawned child receives it, and
    a worker factory (:mod:`repro_torch.serving.procpool`).

    ``devices`` are the cards the pool places this stage's workers on
    (the least-loaded one, lowest index first); ``placed(device)`` is
    the copy a worker on ``device`` gets. In the child,
    :meth:`start_worker` makes that card current — the kernels launch
    through ctypes on the calling thread's current device — loads the
    kernel library the parent built (never building it), builds
    ``make_stage(arch_id, device, full, seed)``, runs ``warmup`` for one
    slot up to ``max_batch``, and returns the stage's ``run_batch``; the
    worker says ``ready`` after that.

    Launch counts live in the child. With ``counts_dir`` set, the child
    keeps a file ``<arch_id>.<pid>.counts`` there, a memory map of
    ``COUNT_FIELDS`` (batches served, then each kernel's launches), zeroed
    after the warm-up and rewritten after every batch, so the counts of
    a worker that is SIGKILLed survive it: :func:`worker_counts` reads
    them. ``matmul_tf32`` is the parent's float32 matmul switch, taken
    when the spec is made, so a worker computes as its parent does.
    """
    arch_id: str
    full: bool = True
    seed: int = 0
    devices: Tuple[str, ...] = ("cuda",)
    max_batch: int = MAX_BATCH
    counts_dir: Optional[str] = None
    device: Optional[str] = None
    matmul_tf32: bool = dataclasses.field(
        default_factory=lambda: torch.backends.cuda.matmul.allow_tf32)

    def placed(self, device: str) -> "ProcessStage":
        return dataclasses.replace(self, device=device)

    def start_worker(self) -> Callable[[List[Any]], List[np.ndarray]]:
        dev = torch.device(self.device or self.devices[0])
        torch.backends.cuda.matmul.allow_tf32 = self.matmul_tf32
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
            _build.load(rebuild=False)
        st = make_stage(self.arch_id, dev, full=self.full, seed=self.seed)
        st.warmup(self.max_batch)
        for c in COUNTERS:
            c.reset()
        if self.counts_dir is None:
            return st.run_batch
        path = Path(self.counts_dir) / f"{self.arch_id}.{os.getpid()}.counts"
        counts = np.memmap(path, dtype=np.int64, mode="w+",
                           shape=(len(COUNT_FIELDS),))
        served = [0]

        def run_batch(payloads: List[Any]) -> List[np.ndarray]:
            out = st.run_batch(payloads)
            served[0] += 1
            counts[:] = [served[0]] + [c.count for c in COUNTERS]
            return out
        return run_batch


def worker_counts(counts_dir: Union[str, Path]
                  ) -> Dict[Tuple[str, int], Dict[str, int]]:
    """The counts every worker of :class:`ProcessStage` wrote under
    ``counts_dir``, by (arch_id, pid): ``{field: n}`` over
    ``COUNT_FIELDS``."""
    out: Dict[Tuple[str, int], Dict[str, int]] = {}
    for path in sorted(Path(counts_dir).glob("*.counts")):
        arch, pid = path.name[:-len(".counts")].rsplit(".", 1)
        vals = np.fromfile(path, dtype=np.int64)
        out[(arch, int(pid))] = dict(zip(COUNT_FIELDS, map(int, vals)))
    return out
