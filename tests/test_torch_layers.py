"""The port's layers (`repro_torch.models.layers`) against the reference
(`repro.models.layers`): the same numpy inputs through both, float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as L
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-6


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_rmsnorm():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7, 64).astype(np.float32) * 3
    scale = rng.randn(64).astype(np.float32) * 0.1
    got = L.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x), 1e-5)
    want = JL.rmsnorm({"scale": jnp.array(scale)}, jnp.array(x), 1e-5)
    _close(got, want)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_split_halves(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(40, 4, 16).astype(np.float32)
    pos = rng.randint(0, 512, 40).astype(np.int32)
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    want = JL.apply_rope(jnp.array(x), jnp.array(pos), theta)
    _close(got, want)


def test_positional_rotate_and_scalar_positions():
    cfg = get_config("llama3.2-3b").reduced()
    jcfg = jax_config("llama3.2-3b").reduced()
    rng = np.random.RandomState(2)
    q = rng.randn(12, 4, 16).astype(np.float32)
    k = rng.randn(12, 2, 16).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    gq, gk = L.positional_rotate(cfg, torch.tensor(q), torch.tensor(k),
                                 torch.tensor(pos), torch.tensor(pos))
    wq, wk = JL.positional_rotate(jcfg, jnp.array(q), jnp.array(k),
                                  jnp.array(pos), jnp.array(pos))
    _close(gq, wq)
    _close(gk, wk)
    sp = L.scalar_positions(cfg, torch.tensor(pos))
    np.testing.assert_array_equal(
        sp.numpy(), np.asarray(JL.scalar_positions(jcfg, jnp.array(pos))))


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_act_fn(name):
    x = np.linspace(-6, 6, 257).astype(np.float32)
    _close(L.act_fn(name)(torch.tensor(x)), JL.act_fn(name)(jnp.array(x)))


@pytest.mark.parametrize("heads,kv,tp", [(24, 8, 1), (4, 2, 1), (12, 4, 8),
                                         (14, 2, 4), (16, 16, 16)])
def test_gqa_layout(heads, kv, tp):
    got = L.gqa_layout(heads, kv, tp)
    want = JL.gqa_layout(heads, kv, tp)
    for f in ("num_heads", "num_kv_heads", "tp", "hpg_pad", "h_pad",
              "kv_sharded", "pad_heads"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.head_mask().numpy(),
                                  np.asarray(want.head_mask()))
    np.testing.assert_array_equal(got.group_of_head().numpy(),
                                  np.asarray(want.group_of_head()))


def test_initializers_follow_the_reference_distributions():
    """Same shapes and distributions as the reference (N(0,1)/sqrt(in),
    N(0,1)*0.02), drawn from an explicit generator: a seed reproduces."""
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return (L.dense_init(gen, 256, 512, torch.float32, "cpu"),
                L.embed_init(gen, 1024, 64, torch.bfloat16, "cpu"))

    w, e = draw(0)
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert e.shape == (1024, 64) and e.dtype == torch.bfloat16
    assert abs(w.std().item() - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert abs(e.float().std().item() - 0.02) < 0.02 * 0.02
    assert abs(w.mean().item()) < 3 * 256 ** -0.5 / 362
    w2, e2 = draw(0)
    assert torch.equal(w, w2) and torch.equal(e, e2)
    assert not torch.equal(w, draw(1)[0])
