"""The port's process backend and data plane on the CPU: the typed slab
codec (``serving/dataplane.py``, bfloat16 by name without ml_dtypes),
the ring replica and its pool (``serving/procpool.py``, spawned workers
by default), the executor on worker processes under SIGKILL, transient
errors and hedging, the asyncio ingress on top, and LOCK01 over the
copies.

The cases are the reference's (``tests/test_procpool.py``,
``tests/test_dataplane.py``, ``tests/test_faults_live.py``), moved to
the port's copies. Spawned workers import the stage fn, so every worker
fn here is a module-level fn of the port (``_scale_payloads``, its
sleeping variant bound with ``functools.partial``, a
:class:`~repro_torch.serving.stage.ProcessStage`). Each spawned child
imports torch, so the cases that spawn are few and all in this file
(one xdist worker under ``--dist loadfile``); every wait has a bound."""

import functools
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.dataplane import decode_batch as ref_decode_batch  # noqa: E402
from repro.serving.dataplane import encode_batch as ref_encode_batch  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    PipelineConfig,
    StageConfig,
    linear_pipeline,
)
from repro_torch.faults import (  # noqa: E402
    FaultSchedule,
    RecoveryPolicy,
    crash,
    transient,
)
from repro_torch.serving import (  # noqa: E402
    SEQ,
    AsyncIngress,
    PipelineExecutor,
    ProcessStage,
    make_stage,
    worker_counts,
)
from repro_torch.serving.dataplane import (  # noqa: E402
    DataplaneStats,
    SlotOverflow,
    decode_batch,
    encode_batch,
)
from repro_torch.serving.procpool import (  # noqa: E402
    DEFAULT_READY_TIMEOUT_S,
    ProcessReplicaPool,
    ProcReplica,
    ReplicaDead,
    StageWorkerError,
    _scale_payloads,
    _sleep_scale_payloads,
    register_worker_fn,
    resolve_worker_fn,
)
from test_torch_control import _analyze  # noqa: E402

def _sleep_fn(delay_s, scale=1):
    return functools.partial(_sleep_scale_payloads, delay_s=delay_s,
                             scale=scale)


def _linear(n_stages=1, batch=4, replicas=1, **kw):
    names = [f"m{i}" for i in range(n_stages)]
    pipe = linear_pipeline("t", names, {n: ["cpu-1"] for n in names})
    cfg = PipelineConfig({s: StageConfig("cpu-1", batch, replicas, **kw)
                          for s in pipe.stages})
    return pipe, cfg


def _wait_until(pred, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _gone(pid: int) -> bool:
    return not os.path.exists(f"/proc/{pid}")


def _slot(nbytes=1 << 16):
    return memoryview(bytearray(nbytes))


def _rand(rng, dtype, shape):
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.integers(0, 2, size=shape).astype(dt)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, size=shape,
                            endpoint=True).astype(dt)
    return rng.standard_normal(size=shape).astype(dt)


def _tensor(rng, dtype, shape):
    return torch.from_numpy(rng.standard_normal(size=shape).astype(
        np.float32)).to(dtype)


DTYPES = [np.float32, np.float64, np.float16, np.int8, np.uint8, np.int32,
          np.int64, np.bool_]
SHAPES = [(), (1,), (7,), (3, 4), (2, 3, 5), (4, 1, 2, 2)]


def _assert_bit_identical(out, src):
    """The codec's contract: type, dtype, shape and the raw bytes all
    survive the trip exactly."""
    if isinstance(src, torch.Tensor):
        assert isinstance(out, torch.Tensor)
        assert out.dtype == src.dtype and out.shape == src.shape
        bits = {torch.bfloat16: torch.int16}.get(src.dtype, src.dtype)
        assert torch.equal(out.view(bits), src.contiguous().view(bits))
        return
    assert isinstance(out, np.ndarray)
    assert out.dtype == src.dtype and out.shape == src.shape
    assert out.tobytes() == np.ascontiguousarray(src).tobytes()


# ------------------------------------------------------ the codec, in-process

@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_codec_roundtrip_and_reference_bytes(dtype):
    """Random numpy dtype/shape batches round-trip bit for bit, and the
    slot holds byte for byte what the reference's codec writes."""
    rng = np.random.default_rng(0)
    ours, theirs = _slot(), _slot()
    for shape in SHAPES:
        for n in (1, 3):
            batch = [_rand(rng, dtype, shape) for _ in range(n)]
            used = encode_batch(ours, batch)
            assert used == ref_encode_batch(theirs, batch)
            assert bytes(ours[:used]) == bytes(theirs[:used])
            out = decode_batch(ours, copy=True)
            assert len(out) == n
            for o, s in zip(out, batch):
                _assert_bit_identical(o, s)
            for o, r in zip(out, ref_decode_batch(theirs, copy=True)):
                assert o.tobytes() == r.tobytes() and o.dtype == r.dtype


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int32, torch.float16],
                         ids=lambda d: str(d).split(".")[-1])
def test_codec_carries_torch_tensors_and_bfloat16_by_name(dtype):
    """CPU tensors ride the typed lane and decode to tensors of their
    dtype; bfloat16 goes by name with its bits as uint16."""
    rng = np.random.default_rng(1)
    slot = _slot()
    for shape in SHAPES:
        batch = [_tensor(rng, dtype, shape) for _ in range(3)]
        stats = DataplaneStats()
        encode_batch(slot, batch, stats)
        assert stats.typed_batches == 1 and stats.pickle_batches == 0
        for copy in (True, False):
            for o, s in zip(decode_batch(slot, copy=copy), batch):
                _assert_bit_identical(o, s)
    if dtype == torch.bfloat16:
        assert b"bfloat16" in bytes(slot[:256])
    # mixed shapes and a mixed numpy/tensor batch: one record each
    mixed = [_tensor(rng, dtype, (2, 3)), _tensor(rng, dtype, (5,)),
             np.arange(4, dtype=np.int16)]
    encode_batch(slot, mixed)
    for o, s in zip(decode_batch(slot, copy=True), mixed):
        _assert_bit_identical(o, s)


def test_codec_noncontiguous_and_fortran_inputs():
    rng = np.random.default_rng(1)
    slot = _slot()
    base = rng.standard_normal((8, 8)).astype(np.float32)
    t = torch.from_numpy(base).to(torch.bfloat16)
    batch = [base[::2, 1::3], np.asfortranarray(base), base[::-1],
             t.t(), t[::2]]
    encode_batch(slot, batch)
    for o, s in zip(decode_batch(slot, copy=True), batch):
        _assert_bit_identical(o, s)


def test_codec_homogeneous_batch_stacks_one_record():
    rng = np.random.default_rng(2)
    slot = _slot()
    for batch in ([rng.standard_normal((4, 4)).astype(np.float32)
                   for _ in range(8)],
                  [_tensor(rng, torch.bfloat16, (4, 4)) for _ in range(8)]):
        stats = DataplaneStats()
        encode_batch(slot, batch, stats)
        assert stats.typed_batches == 1
        out = decode_batch(slot, copy=False)
        for o, s in zip(out, batch):
            _assert_bit_identical(o, s)
        # the rows of a stacked record are views of one block
        guard = np.frombuffer(slot, dtype=np.uint8)
        first = out[0] if isinstance(out[0], np.ndarray) else \
            out[0].view(torch.int16).numpy()
        assert np.may_share_memory(first, guard)


def test_codec_mixed_payloads_take_pickle_lane():
    slot = _slot()
    stats = DataplaneStats()
    batch = [np.arange(3), "a string", {"k": 1}, 7]
    encode_batch(slot, batch, stats)
    assert stats.pickle_batches == 1 and stats.typed_batches == 0
    out = decode_batch(slot, copy=True)
    assert np.array_equal(out[0], np.arange(3))
    assert out[1:] == ["a string", {"k": 1}, 7]
    # object arrays and tensors that need grad cannot ride the typed lane
    encode_batch(slot, [np.array([None, "x"], dtype=object)], stats)
    encode_batch(slot, [torch.ones(3, requires_grad=True)], stats)
    assert stats.pickle_batches == 3


def test_codec_scalars_preserve_exact_types():
    slot = _slot()
    batch = [np.float32(1.5), 3, 2.5]
    encode_batch(slot, batch)
    out = decode_batch(slot, copy=True)
    assert type(out[0]) is np.float32 and type(out[1]) is int
    assert out == batch


def test_codec_overflow_carries_prepickled_bytes():
    slot = _slot(256)
    big = np.ones(10_000)
    with pytest.raises(SlotOverflow) as ei:
        encode_batch(slot, ["not-an-array", big])
    assert ei.value.data is not None          # pickle lane: bytes ride along
    with pytest.raises(SlotOverflow) as ei2:
        encode_batch(slot, [big])
    assert ei2.value.data is None             # typed lane: nothing serialized


def test_codec_zero_copy_views_alias_slot_and_copies_do_not():
    slot = _slot()
    guard = np.frombuffer(slot, dtype=np.uint8)
    for src in (np.arange(16, dtype=np.int64),
                torch.arange(16, dtype=torch.int64)):
        encode_batch(slot, [src])
        view = decode_batch(slot, copy=False)[0]
        owned = decode_batch(slot, copy=True)[0]
        as_np = (lambda x: x.numpy()) if torch.is_tensor(src) else \
            (lambda x: x)
        assert np.may_share_memory(as_np(view), guard)
        assert not np.may_share_memory(as_np(owned), guard)
        view[0] = -1                          # worker-side mutation...
        assert owned[0] == 0                  # ...never reaches owned copies


def test_codec_mutation_cannot_cross_buffers():
    slab = bytearray(1 << 16)
    half = len(slab) // 2
    b0, b1 = memoryview(slab)[:half], memoryview(slab)[half:]
    batch1 = [torch.full((8, 8), 2.0, dtype=torch.bfloat16)]
    encode_batch(b0, [np.full((8, 8), 1.0, np.float32)])
    encode_batch(b1, batch1)
    before = bytes(b1)
    for v in decode_batch(b0, copy=False):
        v[:] = -7.0                            # worker scribbles over buf 0
    encode_batch(b0, [np.ones((31, 31), np.float32)])
    assert bytes(b1) == before
    _assert_bit_identical(decode_batch(b1, copy=True)[0], batch1[0])


def test_codec_inplace_response_with_aliasing_outputs():
    slot = _slot()
    guard = np.frombuffer(slot, dtype=np.uint8)
    srcs = [np.arange(100, dtype=np.float32) * (i + 1) for i in range(3)]
    encode_batch(slot, srcs)
    views = decode_batch(slot, copy=False)
    outs = [v[::-1] for v in views]           # aliasing, non-contiguous
    expect = [np.ascontiguousarray(o) for o in outs]
    encode_batch(slot, outs, guard=guard)     # response in place
    for b, e in zip(decode_batch(slot, copy=True), expect):
        _assert_bit_identical(b, e)


# --------------------------------------------------- the replica primitive

def test_placement_fills_the_least_loaded_device_first():
    """A stage spec names its devices; each new worker goes to the one
    holding the fewest live or starting workers, lowest index first
    (reserved while it starts, so concurrent spawns spread)."""
    spec = ProcessStage("xlstm-125m", full=False,
                        devices=("cuda:2", "cuda:0", "cuda:1"))
    pool = ProcessReplicaPool(spec)
    got = [pool._place() for _ in range(7)]
    assert got == ["cuda:2", "cuda:0", "cuda:1"] * 2 + ["cuda:2"]
    assert spec.placed("cuda:1").device == "cuda:1"
    assert ProcessReplicaPool(_scale_payloads)._place() is None


def test_proc_replica_runs_batches_in_a_spawned_child():
    """A worker started with ``spawn`` (the default) serves ints, numpy
    arrays and bfloat16 tensors through the ring; a fn error in the
    child leaves the replica alive; the fn goes by a registered name."""
    register_worker_fn("torch-procpool-echo", _scale_payloads)
    assert resolve_worker_fn("torch-procpool-echo") is _scale_payloads
    assert resolve_worker_fn(
        "repro_torch.serving.procpool:_scale_payloads") is _scale_payloads
    pool = ProcessReplicaPool("torch-procpool-echo")
    rep = pool.spawn()
    try:
        assert rep.alive() and rep.pid != os.getpid()
        assert 0.0 < rep.ready_s < DEFAULT_READY_TIMEOUT_S
        assert pool.spawn_log() == [(rep.pid, None, rep.ready_s)]
        assert rep.run([1, 2, 3]) == [1, 2, 3]
        rng = np.random.default_rng(4)
        batch = [_tensor(rng, torch.bfloat16, (3, 5)) for _ in range(4)]
        for o, s in zip(rep.run(batch), batch):
            _assert_bit_identical(o, s)
        arr = np.arange(6, dtype=np.int32).reshape(2, 3)
        _assert_bit_identical(rep.run([arr])[0], arr)
        with pytest.raises(StageWorkerError, match="TypeError"):
            rep.run([None, {}])                # {} * 1 raises in the child
        assert rep.alive()                     # fn error != replica death
        assert rep.run([5]) == [5]
        assert rep.transport_stats().typed_batches >= 2
    finally:
        pool.close_all()
    assert not rep.alive() and _gone(rep.pid)
    rep.close()                                # idempotent


def test_proc_replica_oversize_batch_chunks_both_directions():
    """Batches past one ring buffer, ±1 around its capacity, stream
    through the slab in chunks both ways (never the inline pipe)."""
    rep = ProcReplica(_scale_payloads, slab_bytes=4096)
    try:
        for n in (1024, 2047, 2048, 2049, 8192):
            src = np.arange(n, dtype=np.uint8)
            _assert_bit_identical(rep.run([src])[0], src)
        big = np.ones(50_000)
        out = rep.run([big, 2 * big])
        assert [o.sum() for o in out] == [50_000.0, 100_000.0]
        st = rep.transport_stats()
        assert st.chunk_messages > 0 and st.inline_messages == 0
    finally:
        rep.close()


def test_ring_matches_pickle_transport_bitwise():
    rng = np.random.default_rng(3)
    ring = ProcReplica(_scale_payloads, transport="ring")
    legacy = ProcReplica(_scale_payloads, transport="pickle")
    try:
        for dtype in (np.float32, np.int8):
            for shape in [(), (5,), (3, 4)]:
                batch = [_rand(rng, dtype, shape) for _ in range(4)]
                # a 0-d array times 1 is a numpy scalar: the pickle lane
                for x, y, e in zip(ring.run(batch), legacy.run(batch),
                                   _scale_payloads(batch)):
                    assert type(x) is type(y) is type(e)
                    assert x.tobytes() == y.tobytes() == e.tobytes()
                    assert x.dtype == y.dtype == e.dtype
        assert ring.transport_stats().typed_batches > 0
        assert legacy.transport_stats().typed_batches == 0
    finally:
        ring.close()
        legacy.close()


def test_ring_sigkill_with_two_batches_in_flight():
    """SIGKILL a replica with the ring full (one batch computing, one
    handed over): both surface as ReplicaDead for requeue, none lost."""
    rep = ProcReplica(_sleep_fn(5.0))
    try:
        rep.submit([np.float32(1.0)])
        rep.submit([np.float32(2.0)])
        assert rep.free_slots == 0 and rep.inflight == 2
        time.sleep(0.1)
        rep.kill()
        for _ in range(2):
            with pytest.raises(ReplicaDead):
                rep.collect(timeout=5.0)
    finally:
        rep.close()


def test_a_worker_that_cannot_build_its_stage_fails_loudly():
    """A stage spec whose build raises in the child reports the child's
    error at the handshake: the replica never joins the fleet, and the
    pool does not retry a build error."""
    pool = ProcessReplicaPool(ProcessStage("no-such-arch", devices=("cpu",)))
    t0 = time.perf_counter()
    with pytest.raises(StageWorkerError, match="no-such-arch"):
        pool.spawn()
    assert time.perf_counter() - t0 < DEFAULT_READY_TIMEOUT_S
    assert pool.alive_count() == 0 and pool.spawn_log() == []
    pool.close_all()


def test_process_stage_answers_like_the_in_process_stage(tmp_path):
    """A spawned worker builds the smoke cascade stage from the same
    seed and answers a fixed batch bit for bit as ``make_stage`` does in
    this process; its counts file holds the batches it served."""
    spec = ProcessStage("xlstm-125m", full=False, seed=3, devices=("cpu",),
                        max_batch=4, counts_dir=str(tmp_path))
    rows = [np.random.default_rng(i).integers(0, 256, SEQ, dtype=np.int32)
            for i in range(3)]
    local = make_stage("xlstm-125m", "cpu", full=False, seed=3)
    pool = ProcessReplicaPool(spec)
    try:
        rep = pool.spawn()
        assert rep.device == "cpu" and pool.devices() == ["cpu"]
        assert worker_counts(tmp_path)[("xlstm-125m", rep.pid)][
            "batches"] == 0
        for _ in range(2):
            got = rep.run(rows)
            for g, e in zip(got, local.run_batch(rows)):
                _assert_bit_identical(g, e)
        counts = worker_counts(tmp_path)
    finally:
        pool.close_all()
    # two batches; on the CPU the stage takes the plain versions
    assert counts == {("xlstm-125m", rep.pid): {
        "batches": 2, "rmsnorm": 0, "flash_attention": 0,
        "decode_attention": 0, "mamba_scan": 0}}


# ------------------------------------------ the executor on worker processes

def test_process_backend_serves_through_real_processes():
    pipe, cfg = _linear(n_stages=2, batch=4, replicas=2)
    cfg["s1_m1"].replicas = 1
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.002, scale=2),
                                      "m1": _sleep_fn(0.002, scale=5)},
                          backend="process")
    try:
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 2
                           and ex.live_process_count("s1_m1") == 1)
        pids = ex.worker_pids("s0_m0") + ex.worker_pids("s1_m1")
        assert len(set(pids)) == 3 and os.getpid() not in pids
        assert len(ex.worker_spawns("s0_m0")) == 2
        payloads = {}
        ex.on_request_done = lambda r: payloads.setdefault(r.rid, r.payload)
        lat = ex.serve_trace(np.linspace(0.0, 0.3, 24), lambda i: i,
                             timeout_s=20.0)
        assert np.isfinite(lat).all(), lat
        # outputs really crossed both stage processes: i * 2 * 5
        assert payloads == {i: i * 10 for i in range(24)}
        assert ex.dataplane_stats()["s0_m0"].pickle_batches > 0
    finally:
        assert ex.shutdown()
    assert ex.live_process_count("s0_m0") == 0     # no leaked processes
    assert all(_gone(p) for p in pids)


def test_process_backend_scales_both_directions():
    pipe, cfg = _linear(replicas=1, batch=2)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.002)},
                          backend="process")
    try:
        ex.scale("s0_m0", 3)
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 3)
        ex.scale("s0_m0", 1)
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 1)
        assert ex.replica_target("s0_m0") == 1
        assert [c for _, c in ex.replica_timeline["s0_m0"]] == [1, 3, 1]
    finally:
        assert ex.shutdown()


def test_sigkill_mid_handoff_requeues_and_the_survivor_delivers():
    """A scheduled crash SIGKILLs a real process under a double-buffered
    ring; its in-flight batches requeue on the survivor, every request
    finishes exactly once, and the dead pid is gone."""
    pipe, cfg = _linear(replicas=2, batch=2)
    fs = FaultSchedule([crash("s0_m0", 0.08)], seed=0)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.05, scale=2)},
                          faults=fs, backend="process", ring_depth=2)
    done, lock = [], threading.Lock()

    def on_done(r):
        with lock:
            done.append(r.rid)

    ex.on_request_done = on_done
    try:
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 2)
        pids_before = set(ex.worker_pids("s0_m0"))
        lat = ex.serve_trace(np.linspace(0.0, 0.4, 24),
                             lambda i: np.float32(i), timeout_s=20.0)
        assert np.isfinite(lat).all(), lat
        assert sorted(done) == list(range(24))   # exactly once, all 24
        assert ex.outputs() == [np.float32(2 * i) for i in range(24)]
        assert ex.replica_target("s0_m0") == 1
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 1)
        killed = pids_before - set(ex.worker_pids("s0_m0"))
        assert len(killed) == 1 and _wait_until(
            lambda: all(_gone(p) for p in killed))
        deltas = ex.fault_deltas()["s0_m0"]
        assert len(deltas) == 1 and deltas[0][1] == -1
    finally:
        assert ex.shutdown()


def test_crash_then_replacement_on_processes():
    pipe, cfg = _linear(replicas=2, batch=2)
    fs = FaultSchedule([crash("s0_m0", 0.05)], seed=0)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.01)}, faults=fs,
                          backend="process")
    try:
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 2)
        ex.start_run()
        assert _wait_until(lambda: ex.replica_target("s0_m0") == 1)
        ex.add_replicas("s0_m0", 1, t_active=ex.now())
        assert ex.replica_target("s0_m0") == 2
        assert _wait_until(lambda: len(ex.worker_spawns("s0_m0")) == 3
                           and ex.live_process_count("s0_m0") == 2)
        # the final fleet is the replay arithmetic: base - crashes + ups
        assert ex.replica_timeline["s0_m0"][-1][1] == 2
    finally:
        assert ex.shutdown()


def test_all_dead_stage_fast_fails_on_processes():
    pipe, cfg = _linear(replicas=2, batch=2)
    fs = FaultSchedule([crash("s0_m0", 0.05, n=2)], seed=0)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.05)}, faults=fs,
                          backend="process")
    try:
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 2)
        t0 = time.time()
        lat = ex.serve_trace(np.linspace(0.0, 0.3, 12), lambda i: i,
                             timeout_s=30.0)
        assert time.time() - t0 < 8.0, "all-dead stage ate the timeout"
        assert np.isinf(lat).any()
    finally:
        assert ex.shutdown()


def test_exactly_once_under_sigkill_errors_and_hedging():
    """24 of 24, each exactly once, through two stages of worker
    processes while a crash SIGKILLs one of the first stage's workers and
    transient errors fail its batches, retried with hedged duplicates."""
    pipe, cfg = _linear(n_stages=2, replicas=2, batch=2)
    fs = FaultSchedule(
        [crash("s0_m0", 0.1), transient("s0_m0", 0.0, 0.2, 0.6)], seed=5,
        recovery=RecoveryPolicy(max_attempts=12, backoff_s=0.02,
                                backoff_mult=1.5, hedge_slack_s=0.4))
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.004, scale=3),
                                      "m1": _sleep_fn(0.004, scale=2)},
                          faults=fs, backend="process")
    done, lock = [], threading.Lock()

    def on_done(req):
        with lock:
            done.append(req.rid)

    ex.on_request_done = on_done
    try:
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 2
                           and ex.live_process_count("s1_m1") == 2)
        lat = ex.serve_trace(np.linspace(0.0, 0.4, 24), lambda i: i,
                             timeout_s=20.0, slo_s=0.5)
        assert sorted(done) == list(range(24)), "lost or duplicated"
        assert np.isfinite(lat).all(), lat
        assert ex.outputs() == [6 * i for i in range(24)]
        assert [d for _, d in ex.fault_deltas()["s0_m0"]] == [-1]
        # the error window failed batches that were then served again
        assert ex.batch_sizes()["s0_m0"].sum() > 24
    finally:
        assert ex.shutdown()


def test_async_ingress_on_process_backend():
    pipe, cfg = _linear(replicas=2, batch=16)
    ex = PipelineExecutor(pipe, cfg, {"m0": _sleep_fn(0.002)},
                          backend="process")
    try:
        assert _wait_until(lambda: ex.live_process_count("s0_m0") == 2)
        ing = AsyncIngress(ex, clients=32)
        arr = np.sort(np.random.default_rng(0).uniform(0.0, 0.5, 200))
        lat, stats = ing.serve_trace(arr, lambda i: i, timeout_s=20.0,
                                     slo_s=0.5)
        assert np.isfinite(lat).all(), lat
        assert stats.injected == 200
        assert stats.max_lag_s < 0.25          # a loose bound for CI hosts
        assert ex.injection_stats()["n"] == 200
    finally:
        assert ex.shutdown()


# ---------------------------------------------------------------- analyzer

SERVING = ["serving/executor.py", "serving/procpool.py",
           "serving/dataplane.py", "serving/loop.py", "serving/stage.py",
           "serving/ingress.py"]


def test_lock01_finds_nothing_in_the_process_backend_copies(tmp_path):
    """LOCK01 (lock and per-buffer handoff discipline; scope
    ``repro/serving/``) over the port's executor, pool and ring."""
    findings, rc = _analyze(tmp_path, SERVING, "LOCK01")
    assert findings == [], findings
    assert rc == 0


@pytest.mark.parametrize("rel,old,new", [
    ("serving/procpool.py",
     "    def send_ctl(self, *msg) -> None:  # holds-lock: handoff(_conn, buf=*)\n"
     "        self._conn.send(msg)",
     "    def send_ctl(self, *msg) -> None:\n"
     "        self._guards[0][0] = 0\n"
     "        self._conn.send(msg)"),
    ("serving/executor.py",
     "        with st.cond:\n"
     "            st.workers = [t for t in st.workers if t.is_alive()]",
     "        if True:\n"
     "            st.workers = [t for t in st.workers if t.is_alive()]"),
], ids=["ring-buffer", "workers"])
def test_lock01_sees_a_violation_planted_in_the_copies(tmp_path, rel, old,
                                                      new):
    findings, rc = _analyze(tmp_path, SERVING, "LOCK01", (rel, old, new))
    assert findings and {f["path"] for f in findings} == {f"repro/{rel}"}, \
        findings
    assert rc != 0
