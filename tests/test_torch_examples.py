"""The reference's examples as entry points of the port, on the CPU.

- ``repro_torch.examples.quickstart`` and ``.autoscale_spike`` print
  what ``examples/quickstart.py`` and ``examples/autoscale_spike.py``
  print, line for line (both run here, the reference's through
  ``runpy``);
- ``repro_torch.examples.train_arch --device cpu`` learns and
  round-trips its checkpoint, for the dense and the hybrid smoke configs;
- ``repro_torch.examples.serve_real_models.main(device="cpu")`` with
  shortened traces plans a feasible cascade, answers every live request
  with the CPU forward's shifted windows, and runs the closed loop.

The comparisons are exact: the examples print and answer with the same
numpy arithmetic and the same forward on the same inputs.
"""

import contextlib
import io
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import serve_real_models  # noqa: E402
from repro_torch.examples import train_arch  # noqa: E402
from repro_torch.serving.stage import SEQ  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _stdout(run) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run()
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("name", ["quickstart", "autoscale_spike"])
def test_numpy_examples_print_what_the_reference_prints(name):
    ref = _stdout(lambda: runpy.run_path(str(ROOT / "examples" /
                                             f"{name}.py"),
                                         run_name="__main__"))
    port = _stdout(lambda: runpy.run_module(f"repro_torch.examples.{name}",
                                            run_name="__main__"))
    assert len(ref) > 5
    assert port == ref


@pytest.mark.parametrize("arch,steps,batch", [("llama3.2-1b", 30, 8),
                                              ("jamba-1.5-large-398b", 20,
                                               4)])
def test_train_arch_learns_and_round_trips_on_the_cpu(tmp_path, arch, steps,
                                                      batch):
    ckpt = tmp_path / "ckpt.npz"
    lines = []
    losses = None

    def run():
        nonlocal losses
        losses = train_arch.main(["--device", "cpu", "--arch", arch,
                                  "--steps", str(steps), "--batch",
                                  str(batch), "--ckpt", str(ckpt)])
    lines = _stdout(run)
    assert len(losses) == steps and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert ckpt.exists()
    assert lines[0].startswith(f"arch={arch} (reduced)")
    assert lines[-1] == f"checkpoint round-trip OK -> {ckpt}"


def test_serve_real_models_on_the_cpu_answers_with_the_forward():
    out = serve_real_models.main("cpu", sample_s=10.0, live_s=3.0,
                                 tune_sample_s=10.0,
                                 spike_s=(2.0, 2.0, 3.0))
    assert out["plan"].feasible
    lat, outputs = out["latency"], out["outputs"]
    assert lat.size == out["trace"].size == len(outputs)
    assert np.isfinite(lat).all()
    stages = [out["stages"][s] for s in serve_real_models.ARCHES]
    expected = {}
    with torch.inference_mode():
        for k in range(50):
            window = torch.full((1, SEQ), k, dtype=torch.int32)
            for st in stages:
                logits, _ = st.model.forward(st.params, {"tokens": window})
                nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
                window = torch.cat([window[:, 1:], nxt[:, None]], dim=1)
            expected[k] = window[0].numpy()
    for i, got in enumerate(outputs):
        np.testing.assert_array_equal(got, expected[i % 50])
    run = out["loop"]
    assert run.released == 0 and np.isfinite(run.latency).all()
    assert run.latency.size > 0
