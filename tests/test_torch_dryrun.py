"""The port's dry-run (``repro_torch.launch.dryrun``) on the ``meta``
device over the ``fake`` process group, and its roofline arithmetic.

Each combination runs in a subprocess (the fake group is process-global
and sized by the mesh): llama3.2-1b x the four shapes on the single-pod
mesh (long_500k through llama3.2-1b-sw), granite-moe-1b-a400m
train_4k on the multi-pod mesh, deepseek-v3-671b decode_32k (MLA's
absorbed decode over the latent cache, the MoE, MTP's weights) and
jamba-1.5-large-398b long_500k (Mamba, natively sub-quadratic) on the
single-pod mesh must be ``ok`` on 256 / 512 chips; the
per-device parameter bytes must equal, exactly, the sum of the local
shard sizes the reference's ``param_pspec`` gives under its
``dryrun_config``, a stacked dense FFN weight taken under the dense
rule the port runs (``execution_placements``' one difference in
bytes); training FLOPs must reach 6 N T / chips; an
architecture the port does not shard or build yet must be ``skipped``
with its reason. The roofline terms are checked as
``tests/test_roofline.py`` checks the reference's, against one H100's
constants (pytest.approx's default relative 1e-6).
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch.shapes import dryrun_config as jax_dryrun_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.sharding import (  # noqa: E402
    _FFN_DENSE,
    _FFN_RE,
    _resolve,
    param_pspec,
)
from repro_torch.core.hardware import (  # noqa: E402
    H100_HBM_BW,
    H100_NVLINK_BW,
    H100_PEAK_FLOPS_BF16,
)
from repro_torch.roofline.analysis import (  # noqa: E402
    RooflineReport,
    model_flops_estimate,
    roofline_terms,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OK = [("llama3.2-1b", s, "single") for s in
      ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + \
    [("granite-moe-1b-a400m", "train_4k", "multi"),
     ("deepseek-v3-671b", "decode_32k", "single"),
     ("jamba-1.5-large-398b", "long_500k", "single")]
SKIPPED = [("xlstm-125m", "train_4k", "single", "A11b"),
           ("whisper-small", "prefill_32k", "single", "A11b"),
           ("qwen2-72b", "long_500k", "single", "sliding-window")]
MESH = {"single": (("data", "model"), (16, 16)),
        "multi": (("pod", "data", "model"), (2, 16, 16))}
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Every case's artifact, each from its own subprocess (all started
    at once)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape, mesh, *_ in OK + SKIPPED:
        procs[(arch, shape, mesh)] = subprocess.Popen(
            [sys.executable, "-W", "ignore", "-m",
             "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", mesh, "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=ROOT)
    arts = {}
    for key, p in procs.items():
        try:
            log, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        path = out / f"{key[0]}__{key[1]}__{key[2]}.json"
        arts[key] = json.loads(path.read_text()) if path.exists() else \
            {"status": "missing", "log": log.decode(errors="replace")}
    return arts


def _reference_param_bytes(arch, shape, mesh):
    """Sum over the leaves of one device's shard bytes under the
    reference's param_pspec and dryrun_config, with the one by-design
    difference in bytes of the port's layout: a stacked dense FFN
    weight (repeat, D, F) takes the dense rule the reference documents
    (D over the data axes, F over `model`), where param_pspec puts the
    layer axis over `model` (the same bytes where the layers divide
    `model`) or, where they do not, replicates the weight there."""
    axes, dims = MESH[mesh]
    stub = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))
    data = int(np.prod(dims[:-1]))
    cfg, _ = jax_dryrun_config(jax_get_arch(arch), JAX_SHAPES[shape], data)
    model = jax_build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    specs = param_pspec(params, stub)
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    total = 0
    for (path, leaf), spec in zip(leaves, jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        m = _FFN_RE.search("".join(str(p) for p in path))
        if m and str(path[0]) == "['segments']" and leaf.ndim == 3:
            spec = _resolve(_FFN_DENSE[m.group(1)], leaf.shape, stub)
        n = 1
        for d, size in enumerate(leaf.shape):
            entry = spec[d] if d < len(spec) else None
            parts = 1
            for a in (entry if isinstance(entry, tuple) else
                      (entry,) if entry else ()):
                parts *= stub.shape[a]
            n *= size // parts
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("case", OK, ids=lambda c: "__".join(c))
def test_dryrun_ok_on_the_production_meshes(artifacts, case):
    art = artifacts[case]
    assert art["status"] == "ok", art.get("traceback") or art.get("log")
    assert art["chips"] == (256 if case[2] == "single" else 512)
    r = art["roofline"]
    for key in ("t_compute_s", "t_memory_s", "hlo_flops", "hlo_bytes"):
        assert r[key] > 0, key
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert set(r["collectives_by_kind"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert r["collective_bytes"] > 0
    assert art["peak_bytes_per_device"] >= \
        art["memory_analysis"]["argument_size_in_bytes"]
    assert art["peak_bytes_per_device"] <= art["hbm_bytes"] == 80e9
    if case[1] == "long_500k":      # the -sw variant stands in for llama
        assert art["arch_effective"] == {
            "llama3.2-1b": "llama3.2-1b-sw"}.get(case[0], case[0])


@pytest.mark.parametrize("case", OK, ids=lambda c: "__".join(c))
def test_param_bytes_equal_the_reference_shards(artifacts, case):
    art = artifacts[case]
    assert art["status"] == "ok"
    arch = art["arch_effective"]
    assert art["param_bytes_per_device"] == \
        _reference_param_bytes(arch, case[1], case[2])


@pytest.mark.parametrize("case", [c for c in OK if c[1] == "train_4k"],
                         ids=lambda c: "__".join(c))
def test_training_flops_reach_6nt(artifacts, case):
    art = artifacts[case]
    r = art["roofline"]
    cfg = jax_get_arch(case[0])
    tokens = JAX_SHAPES["train_4k"].batch * JAX_SHAPES["train_4k"].seq
    assert r["model_flops"] == pytest.approx(
        6.0 * cfg.active_param_count() * tokens, rel=1e-3)
    assert r["hlo_flops"] >= r["model_flops"] / art["chips"]
    assert 0 < r["useful_flops_ratio"] <= 1


@pytest.mark.parametrize("case", SKIPPED, ids=lambda c: "__".join(c[:3]))
def test_architectures_not_sharded_or_built_yet_are_skipped(artifacts, case):
    art = artifacts[case[:3]]
    assert art["status"] == "skipped"
    assert case[3] in art["reason"]


def test_roofline_terms_arithmetic():
    """Per-device values over one card's peak, as the reference's."""
    rep = RooflineReport(
        arch="a", shape="s", mesh="single", chips=256,
        hlo_flops=1e15, hlo_bytes=1e12, collective_bytes=1e10,
        collectives_by_kind={}, model_flops=0.2e18)
    assert rep.t_compute == pytest.approx(1e15 / H100_PEAK_FLOPS_BF16)
    assert rep.t_memory == pytest.approx(1e12 / H100_HBM_BW)
    assert rep.t_collective == pytest.approx(1e10 / H100_NVLINK_BW)
    assert rep.bottleneck == "compute"
    assert rep.total_hlo_flops == pytest.approx(256e15)
    assert rep.useful_flops_ratio == pytest.approx(0.2e18 / 256e15)
    assert rep.step_time == rep.t_compute


def test_roofline_analytic_floors_and_bottleneck():
    rep = RooflineReport(
        arch="a", shape="s", mesh="single", chips=256,
        hlo_flops=1e12, hlo_bytes=1e9, collective_bytes=0.0,
        collectives_by_kind={}, model_flops=2.56e18, analytic_bytes=5e12)
    assert rep.t_compute == pytest.approx(1e16 / H100_PEAK_FLOPS_BF16)
    assert rep.t_memory == pytest.approx(5e12 / H100_HBM_BW)
    rep = roofline_terms("a", "s", "m", 1, flops=1.0, bytes_accessed=1.0,
                         collectives_by_kind={"all-reduce": 10**12,
                                              "all-gather": 5},
                         model_flops=1.0)
    assert rep.collective_bytes == 10**12 + 5
    assert rep.bottleneck == "collective"
    assert model_flops_estimate(1e9, 1e6, "train") == 6e15
    assert model_flops_estimate(1e9, 1e6, "decode") == 2e15


def test_meshes_start_their_own_groups():
    """make_production_mesh starts the fake backend at 256 / 512 ranks
    (in a fresh process each: the group is process-global), and
    make_host_mesh a one-rank gloo group, over which the sharded model is
    the plain one."""
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import mesh as M\n"
        "kind = sys.argv[1]\n"
        "if kind == 'host':\n"
        "    from repro_torch.configs import get_smoke\n"
        "    from repro_torch.models import build_model\n"
        "    from repro_torch.models.parallel import build_sharded\n"
        "    m = M.make_host_mesh()\n"
        "    cfg = get_smoke('llama3.2-1b')\n"
        "    p = build_model(cfg, 'cpu').init(torch.Generator().manual_seed(0))\n"
        "    t = {'tokens': torch.arange(16).reshape(2, 8)}\n"
        "    a = build_sharded(cfg, m, 'cpu').forward(p, t)[0]\n"
        "    b = build_model(cfg, 'cpu').forward(p, t)[0]\n"
        "    print(tuple(m.shape), m.mesh_dim_names, bool(torch.equal(a, b)))\n"
        "else:\n"
        "    m = M.make_production_mesh(multi_pod=(kind == 'multi'))\n"
        "    print(tuple(m.shape), m.mesh_dim_names, m.size())\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    want = {"single": "(16, 16) ('data', 'model') 256",
            "multi": "(2, 16, 16) ('pod', 'data', 'model') 512",
            "host": "(1, 1) ('data', 'model') True"}
    for kind, line in want.items():
        run = subprocess.run([sys.executable, "-W", "ignore", "-c", code,
                              kind], env=env, capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        assert run.stdout.strip().splitlines()[-1] == line
