"""The port's attention layers (layers/attention.py) against the JAX
package's, from identical parameters and numpy inputs, on the CPU. f32
throughout: bound 1e-5 (same formulas; sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity

from keras_rs_tpu.layers import attention as jattn
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.layers import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)
B, T, D, HEADS = 2, 64, 32, 4


def _x_and_mask(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[:, 50:] = 0.0  # right padding: every query sees key 0
    mask[1, 10:20] = 0.0
    return x, mask


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((5, 7, D)) + 1.0).astype(np.float32)
    jnorm = jattn.LayerNorm(D)
    jnorm.scale = jnp.asarray(rng.uniform(0.5, 1.5, D).astype(np.float32))
    jnorm.offset = jnp.asarray(rng.standard_normal(D).astype(np.float32))
    tnorm = tattn.LayerNorm(D, device="cpu")
    convert.load_params(tnorm, {"scale": np.asarray(jnorm.scale),
                                "offset": np.asarray(jnorm.offset)})
    np.testing.assert_allclose(
        tnorm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jnorm(jnp.asarray(x))), **TOL)


def _mha_pair(use_flash):
    jmha = jattn.MultiHeadSelfAttention(D, HEADS, key=jax.random.key(0))
    tmha = tattn.MultiHeadSelfAttention(D, HEADS, use_flash=use_flash,
                                        device="cpu")
    convert.load_params(tmha, {w: np.asarray(getattr(jmha, w))
                               for w in ("wq", "wk", "wv", "wo")})
    return jmha, tmha


@pytest.mark.parametrize("causal", [True, False])
def test_mha_einsum_path_matches_jax(causal):
    x, mask = _x_and_mask(1)
    jmha, tmha = _mha_pair(use_flash=False)
    want = jmha(jnp.asarray(x), padding_mask=jnp.asarray(mask),
                causal=causal)
    got = tmha(torch.from_numpy(x), padding_mask=torch.from_numpy(mask),
               causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_mha_flash_path_matches_jax_flash_path():
    """use_flash=True on both sides: the JAX layer reaches the Pallas
    kernels in interpret mode, the port's the plain versions of B5-B7."""
    x, mask = _x_and_mask(2)
    jmha, tmha = _mha_pair(use_flash=True)
    import keras_rs_tpu.ops.flash_attention as fa_mod

    orig = fa_mod.flash_attention
    fa_mod.flash_attention = lambda *a, **kw: orig(
        *a, **{**kw, "interpret": True})
    try:
        jmha.use_flash = True
        want = jmha(jnp.asarray(x), padding_mask=jnp.asarray(mask))
    finally:
        fa_mod.flash_attention = orig
    got = tmha(torch.from_numpy(x), padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_auto_takes_the_einsum_path_on_the_cpu(monkeypatch):
    x, mask = _x_and_mask(3)
    _, tmha = _mha_pair(use_flash="auto")
    monkeypatch.setattr(tattn, "FLASH_MIN_T", 1)
    calls = []
    monkeypatch.setattr(tattn.fa, "flash_attention",
                        lambda *a, **kw: calls.append(1))
    tmha(torch.from_numpy(x), padding_mask=torch.from_numpy(mask))
    assert not calls


@pytest.mark.parametrize("head_dim, T, expect", [
    (160, 128, False), (128, 128, True), (50, 1024, True),
    (128, tattn.FLASH_MIN_T - 1, False),
])
def test_auto_gate_refuses_head_dims_the_kernels_lack(head_dim, T, expect):
    """On a CUDA tensor "auto" takes the kernels only for head_dim <=
    MAX_HEAD_DIM (above it, the einsum path); use_flash=True does not
    consult the gate. The gate reads only the tensor's device and shape,
    so a stand-in tensor tests it without a card."""
    import types

    mha = tattn.MultiHeadSelfAttention(head_dim, 1, use_flash="auto",
                                       device="cpu")
    x = types.SimpleNamespace(is_cuda=True, shape=(2, T, head_dim))
    assert mha._flash_enabled(x) is expect
    mha.use_flash = True
    assert mha._flash_enabled(x)


@pytest.mark.parametrize("use_flash", [False, True])
def test_transformer_block_matches_jax(use_flash):
    x, mask = _x_and_mask(4)
    jblock = jattn.TransformerBlock(D, HEADS, 48, key=jax.random.key(5))
    tblock = tattn.TransformerBlock(D, HEADS, 48, device="cpu")
    tblock.attention.use_flash = use_flash
    convert.load_params(tblock, torch_parity.jax_block_params(jblock))
    want = jblock(jnp.asarray(x), padding_mask=jnp.asarray(mask))
    got = tblock(torch.from_numpy(x), padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_embedding_lookup_and_attend():
    rng = np.random.default_rng(6)
    table = rng.standard_normal((11, D)).astype(np.float32)
    jemb = jattn.Embedding(11, D, key=jax.random.key(0))
    jemb.embeddings = jnp.asarray(table)
    temb = tattn.Embedding(11, D, device="cpu")
    convert.load_params(temb, {"embeddings": table})
    ids = rng.integers(0, 11, size=(3, 5))
    x = rng.standard_normal((3, D)).astype(np.float32)
    np.testing.assert_array_equal(
        temb(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jemb(jnp.asarray(ids))))
    np.testing.assert_allclose(
        temb.attend(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jemb.attend(jnp.asarray(x))), **TOL)
