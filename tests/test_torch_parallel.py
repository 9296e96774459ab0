"""Sharded serving and training of the dense, MoE, MLA and hybrid
families on the CPU (gloo), against the JAX reference's unsharded model.

One spawn a mesh, module-scoped: DATA x MODEL processes run
``tests/_torch_parallel_ranks.py``, each join under its own timeout of
at most 120 s (a hung rank is killed and its mesh's cases fail), and
each case is one parametrised assertion. Meshes ``(1, 2)``, ``(1, 4)``
and ``(2, 2)``; smoke configs of llama3.2-1b (tied embeddings), qwen2-72b
(QKV bias; its 2 KV heads fall back to a sequence-split cache on model
4), granite-34b (one KV head: the fallback on every mesh) and
granite-moe-1b-a400m (experts over ``model``; on ``(2, 2)`` its rows
gathered over data), granite-moe with 2 routing groups (on ``(2, 2)``,
each data rank routes its own group), and llama3.2-1b-sw as long_500k
runs it (a batch of 1 on every data rank, the window-capped ring
cache's sequence over the data axes: on ``(2, 2)`` decode combines
partial softmaxes over data), deepseek-v3-671b (MLA's heads over
``model`` with the latent cache whole on every rank, the MoE with its
shared expert, MTP in the loss) and jamba-1.5-large-398b (Mamba's
channels over ``model``, its attention layer's 2 KV heads taking the
sequence-split cache on model 4, the MoE every other layer).

Tolerances: logits of the forward, the prefill and every greedy step at
the port's model bar, f32 atol 1e-4 / rtol 1e-4
(tests/test_torch_families.py); greedy tokens equal; the loss, every
leaf's gradient and the global gradient norm at the train tests' 5e-4
(atol and rtol; tests/test_torch_train.py). xLSTM, whisper
(encoder-decoder) and pixtral (image) raise ``NotImplementedError``
naming ROADMAP A11b.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
JOIN_S = 120
MESHES = ((1, 2), (1, 4), (2, 2))
ARCHS = ("llama3.2-1b", "qwen2-72b", "granite-34b", "granite-moe-1b-a400m")
CASES = ARCHS + ("granite-moe-1b-a400m/groups2", "llama3.2-1b-sw/long",
                 "deepseek-v3-671b", "jamba-1.5-large-398b")
RAISES = ("xlstm-125m", "whisper-small", "pixtral-12b")
RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_torch_parallel_ranks.py")
BATCH, SEQ, PROMPT, SMAX, STEPS = 4, 16, 8, 32, 6


def _configs(name):
    arch, _, variant = name.partition("/")
    jcfg, cfg = jax_get_smoke(arch), get_smoke(arch)
    if variant == "groups2":
        jcfg = dataclasses.replace(jcfg, moe_groups=2)
        cfg = dataclasses.replace(cfg, moe_groups=2)
    return jcfg, cfg, variant


def _reference(name):
    """Inputs and the JAX model's outputs for one case."""
    jcfg, cfg, variant = _configs(name)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    batch = 1 if variant == "long" else BATCH
    tokens = rng.integers(0, cfg.vocab_size, (batch, SEQ)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab_size,
                          (batch, PROMPT)).astype(np.int32)
    logits, aux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)})
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {"tokens": jnp.asarray(tokens)})
    out, state = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(prompt)}, SMAX)
    step = jax.jit(jm.decode_step)
    steps, toks = [out], [jnp.argmax(out, -1)]
    for i in range(STEPS):
        out, state = step(jp, toks[-1], PROMPT + i, state)
        steps.append(out)
        toks.append(jnp.argmax(out, -1))
    flat = jax.tree_util.tree_leaves(grads)
    case = dict(cfg=cfg, params=jax.tree.map(np.asarray, jp), tokens=tokens,
                prompt=prompt, smax=SMAX, steps=STEPS)
    if variant == "long":
        # long_500k's policy: a batch of 1 on every data rank, the
        # cache's sequence over the data axes
        case.update(over_data=False, shard_seq=True)
    want = dict(logits=np.asarray(logits), aux=float(aux),
                loss=float(loss), grads=[np.asarray(g) for g in flat],
                grad_sq_norm=float(sum(jnp.sum(jnp.square(g))
                                       for g in flat)),
                step_logits=np.concatenate([np.asarray(s) for s in steps],
                                           1),
                tokens=np.concatenate([np.asarray(t) for t in toks], 1))
    return case, want


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """(workdir, {case: JAX outputs}); the inputs pickled for the ranks."""
    workdir = tmp_path_factory.mktemp("parallel")
    cases, wants = {}, {}
    for name in CASES:
        cases[name], wants[name] = _reference(name)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    return workdir, wants


def _spawn(workdir, data: int, model: int) -> dict:
    """Run the mesh's ranks; each join waits at most JOIN_S seconds from
    the start, then the rank is killed. Returns rank 0's results, or
    {"error": ...}."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, RANKS, str(r), str(data), str(model), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(data * model)]
    deadline = time.monotonic() + JOIN_S
    logs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed = True
        logs.append(out.decode(errors="replace"))
        failed = failed or p.returncode != 0
    path = workdir / f"out_{data}x{model}.pkl"
    if failed or not path.exists():
        return {"error": "\n".join(logs)[-6000:]}
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(refs):
    workdir, _ = refs
    cache = {}

    def get(mesh):
        if mesh not in cache:
            cache[mesh] = _spawn(workdir, *mesh)
        return cache[mesh]
    return get


def _got(results, mesh, name) -> dict:
    res = results(mesh)
    assert "error" not in res, res["error"]
    got = res[name]
    assert "error" not in got, got["error"]
    return got


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_forward_matches_jax(results, refs, mesh, name):
    got, want = _got(results, mesh, name), refs[1][name]
    np.testing.assert_allclose(got["logits"], want["logits"], **MODEL_TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], **MODEL_TOL)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_prefill_and_greedy_decode_match_jax(results, refs, mesh,
                                                     name):
    got, want = _got(results, mesh, name), refs[1][name]
    np.testing.assert_allclose(got["step_logits"], want["step_logits"],
                               **MODEL_TOL)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_train_step_loss_and_grads_match_jax(results, refs, mesh,
                                                     name):
    got, want = _got(results, mesh, name), refs[1][name]
    np.testing.assert_allclose(got["loss"], want["loss"], **GRAD_TOL)
    assert len(got["grads"]) == len(want["grads"])
    for g, w in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    np.testing.assert_allclose(got["grad_sq_norm"], want["grad_sq_norm"],
                               **GRAD_TOL)


@pytest.mark.parametrize("arch", RAISES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_families_not_sharded_yet_raise_under_a_mesh(results, mesh, arch):
    res = results(mesh)
    assert "error" not in res, res["error"]
    msg = res[f"raises/{arch}"]
    assert msg is not None and "A11b" in msg, msg
