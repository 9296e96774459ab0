"""The port's serving path on the CPU: the trimmed executor serving a
two-stage smoke cascade, its FIFO formation rules, and the control-plane
copies (hardware, pipeline, profiler, trace generator) against the JAX
package's originals."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hardware as jax_hardware  # noqa: E402
from repro.core.pipeline import linear_pipeline as ref_linear_pipeline  # noqa: E402
from repro.core.profiler import ModelProfile as RefModelProfile  # noqa: E402
from repro.workload.generator import gamma_trace as ref_gamma_trace  # noqa: E402
from repro_torch.core.hardware import HARDWARE_MENU, get_hardware  # noqa: E402
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
from repro_torch.serving import SEQ, PipelineExecutor, make_stage  # noqa: E402
from repro_torch.serving.executor import FifoQueue  # noqa: E402
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


@pytest.mark.parametrize("bad", ["edf", "join"])
def test_executor_rejects_what_this_slice_does_not_serve(bad):
    stages = {s: Stage(s, s, ("cpu-1",)) for s in "abc"}
    edges = [Edge(SOURCE, "a"), Edge(SOURCE, "b"), Edge("a", "c"),
             Edge("b", "c")]
    pipe = Pipeline("diamond", stages, edges)
    config = _config(pipe, batch_size=1)
    if bad == "edf":
        pipe = linear_pipeline("one", ["m"], {"m": ["cpu-1"]})
        config = PipelineConfig({s: StageConfig("cpu-1", 1, 1, policy="edf")
                                 for s in pipe.stages})
    with pytest.raises(ValueError):
        PipelineExecutor(pipe, config, {s: (lambda p: p) for s in "abcm"})


def test_fifo_queue_holds_a_partial_batch_until_its_timeout():
    q = FifoQueue(timeout_s=0.1)
    for i in range(3):
        q.push(i, ready=0.0)
    assert q.form_batch(0.05, max_batch=4) == []
    assert q.next_ready_after(0.05, max_batch=4) == pytest.approx(0.1)
    assert q.form_batch(0.1, max_batch=4) == [0, 1, 2]
    for i in range(5):
        q.push(i, ready=1.0)
    assert q.form_batch(0.5, max_batch=4) == []          # none ready yet
    assert q.form_batch(1.0, max_batch=4) == [0, 1, 2, 3]  # full: no hold
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


def test_make_stage_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        make_stage("llama3.2-1b", full=False)
