"""The port's models on the CPU against the JAX reference.

The JAX ``Model.forward`` (on the CPU it runs the reference's plain
kernels) and the port's forward take the same parameters: the JAX
package initialises them and ``params_from_numpy`` carries them over.
Tolerance f32 atol 1e-4 / rtol 1e-4: the two frameworks sum in other
orders, and the observed max difference is ~1e-5 on logits of
magnitude ~1.5. The port's own ``init`` is checked for shapes and
dtypes only, since JAX's PRNG streams cannot be reproduced.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_arch, get_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.device import resolve_device, torch_dtype  # noqa: E402
from repro_torch.models import Block, Segment, build_model  # noqa: E402

ARCHS = ["llama3.2-1b", "llama3.2-1b-sw", "xlstm-125m"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the suite runs several workers on one host: keep torch's intra-op
    # pool small so timing-bound tests elsewhere keep their cores
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch,seq", [
    ("llama3.2-1b", 32),
    ("llama3.2-1b-sw", 96),     # S > the smoke window of 64
    ("xlstm-125m", 32),
    ("xlstm-125m", 128),        # two mLSTM chunks of 64: the carried state
])
def test_forward_matches_jax(arch, seq):
    jmodel = jax_build_model(jax_get_smoke(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, jmodel.cfg.vocab_size, (2, seq)).astype(np.int32)
    exp, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})

    model = build_model(get_smoke(arch), "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    got, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_reference_shapes_and_dtypes(arch):
    jmodel = jax_build_model(jax_get_smoke(arch))
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    model = build_model(get_smoke(arch), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    got = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
        params)
    assert got == want
    again = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(params["embed"], again["embed"])    # seeded


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("getter", ["arch", "smoke"])
def test_configs_copy_the_reference(arch, getter):
    ours = (get_arch if getter == "arch" else get_smoke)(arch)
    theirs = (jax_get_arch if getter == "arch" else jax_get_smoke)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_count() == theirs.param_count()
    assert ours.pdtype == torch_dtype(theirs.param_dtype)


def test_published_widths():
    llama, xlstm = get_arch("llama3.2-1b"), get_arch("xlstm-125m")
    assert (llama.num_layers, llama.d_model, llama.num_heads,
            llama.num_kv_heads, llama.resolved_head_dim, llama.d_ff,
            llama.vocab_size, llama.rope_theta, llama.tie_embeddings) == \
        (16, 2048, 32, 8, 64, 8192, 128256, 5e5, True)
    assert (xlstm.num_layers, xlstm.d_model, xlstm.num_heads,
            xlstm.vocab_size, xlstm.tie_embeddings) == \
        (12, 768, 4, 50304, True)
    assert [b.kind for b in xlstm.segments[0].blocks] == \
        ["mlstm", "mlstm", "mlstm", "slstm"]


def test_params_from_numpy_keeps_bfloat16_bits():
    a = jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)
                    ).astype(jnp.bfloat16).reshape(2, 3, 4)
    tree = {"w": (np.asarray(a),), "b": np.arange(3, dtype=np.int32)}
    out = params_from_numpy(tree, "cpu")
    assert out["w"][0].dtype == torch.bfloat16
    assert isinstance(out["w"], tuple)
    np.testing.assert_array_equal(out["w"][0].view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
    np.testing.assert_array_equal(out["b"].numpy(), tree["b"])


@pytest.mark.parametrize("change", [
    dict(use_mla=True),
    dict(num_image_tokens=4),
    dict(segments=(Segment((Block("attn", "moe"),), 1),)),
    dict(segments=(Segment((Block("mamba", "none"),), 1),)),
], ids=["mla", "vlm", "moe", "mamba"])
def test_families_of_later_slices_raise(change):
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), **change)
    with pytest.raises(NotImplementedError):
        build_model(cfg, "cpu")


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_without_a_gpu_raises(device):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device(device)
    with pytest.raises(RuntimeError, match="no GPU"):
        build_model(get_smoke("llama3.2-1b"), device)
