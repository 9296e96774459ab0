"""Sharded serving and training of every family on the CPU (gloo),
against the JAX reference's unsharded model.

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
shared expert, MTP in the loss), jamba-1.5-large-398b (Mamba's
channels over ``model``, its attention layer's 2 KV heads taking the
sequence-split cache on model 4, the MoE every other layer),
xlstm-125m (an mLSTM's heads over ``model``, the sLSTM replicated;
with one head, ``model`` splits it and every rank runs the whole cell
on weights gathered over ``model``), whisper-small (the encoder's
layers and the cross-attention's heads over ``model``, 16 stub frames
a row; with a vocabulary of 509, which divides no ``model``, the
embedding and the head replicated there, as whisper's 51865 are) and
pixtral-12b (16 stub image features a row, their prefix's rows over
the data axes with the text's; and cut to two stacked layers, as the
card's four-card training runs it).

Tolerances: logits of the forward, the prefill and every greedy step at
the port's model bar, f32 atol 1e-4 / rtol 1e-4
(tests/test_torch_families.py); greedy tokens equal; the loss, every
leaf's gradient and the global gradient norm at the train tests' 5e-4
(atol and rtol; tests/test_torch_train.py). Beside the parity cases,
each of the last three families builds a ``ShardedModel`` on a stub
mesh of each shape, whose local leaves hold the reference's shards
(tests/_torch_shards.py).
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

from _torch_shards import check_local_shapes  # noqa: E402

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)
JOIN_S = 120
MESHES = ((1, 2), (1, 4), (2, 2))
ARCHS = ("llama3.2-1b", "qwen2-72b", "granite-34b", "granite-moe-1b-a400m")
FAMILIES = ("xlstm-125m", "whisper-small", "pixtral-12b")
CASES = ARCHS + ("granite-moe-1b-a400m/groups2", "llama3.2-1b-sw/long",
                 "deepseek-v3-671b", "jamba-1.5-large-398b") + FAMILIES + (
    "xlstm-125m/heads1", "whisper-small/vocab509", "pixtral-12b/2L")
RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_torch_parallel_ranks.py")
BATCH, SEQ, PROMPT, SMAX, STEPS = 4, 16, 8, 32, 6
FRAMES = 16         # whisper's stub frames a row


def _configs(name):
    arch, _, variant = name.partition("/")
    jcfg, cfg = jax_get_smoke(arch), get_smoke(arch)
    change = {"groups2": dict(moe_groups=2),
              "heads1": dict(num_heads=1, num_kv_heads=1),
              "vocab509": dict(vocab_size=509)}.get(variant, {})
    if variant == "2L":     # two stacked layers, as the card's cut runs
        return tuple(dataclasses.replace(c, segments=(dataclasses.replace(
            c.segments[0], repeat=2),)) for c in (jcfg, cfg)) + (variant,)
    return (dataclasses.replace(jcfg, **change),
            dataclasses.replace(cfg, **change), variant)


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
    feats, prompt_feats = _feats(cfg, rng, batch), _feats(cfg, rng, batch)
    fwd = {"tokens": jnp.asarray(tokens),
           **{k: jnp.asarray(v) for k, v in feats.items()}}
    logits, aux = jax.jit(jm.forward)(jp, fwd)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(jp, fwd)
    out, state = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(prompt),
             **{k: jnp.asarray(v) for k, v in prompt_feats.items()}}, SMAX)
    step = jax.jit(jm.decode_step)
    steps, toks = [out], [jnp.argmax(out, -1)]
    for i in range(STEPS):      # a position counts an image prefix
        out, state = step(jp, toks[-1], PROMPT + cfg.num_image_tokens + i,
                          state)
        steps.append(out)
        toks.append(jnp.argmax(out, -1))
    flat = jax.tree_util.tree_leaves(grads)
    case = dict(cfg=cfg, params=jax.tree.map(np.asarray, jp), tokens=tokens,
                prompt=prompt, smax=SMAX, steps=STEPS, feats=feats,
                prompt_feats=prompt_feats)
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


def _feats(cfg, rng, batch) -> dict:
    """The modality stub's features of ``batch`` rows, as numpy."""
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal((batch, FRAMES, 128),
                                              dtype=np.float32)}
    if cfg.num_image_tokens:
        return {"image_feats": rng.standard_normal(
            (batch, cfg.num_image_tokens, 1024), dtype=np.float32)}
    return {}


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


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_families_not_sharded_yet_raise_under_a_mesh(mesh, arch):
    """Once refused under a mesh: each family now builds a ShardedModel
    on a stub mesh of this shape, and every rank's local leaves have
    the shapes of the reference's shards."""
    check_local_shapes(get_smoke(arch), *mesh)
