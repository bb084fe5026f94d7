"""The port's torch threefry against ``jax.random`` (partitionable
threefry, jax's default here): keys, ``fold_in``, raw bits and uniforms
bit-equal, categorical draws equal, over 64 keys and several shapes.
Gumbel noise is held to 2e-6 relative: XLA's CPU ``log`` is not
correctly rounded, torch's is, so the two differ in the last ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops import prng


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six workers on this machine's cores: keep torch's
    tiny-tensor math on one thread so it does not crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 7, 42, 12345, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 33 + 5] \
    + list(range(1000, 1056))


def u32(a):
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def test_partitionable_threefry_is_jax_default():
    assert jax.config.jax_threefry_partitionable
    assert prng.prng_key(7).tolist() == [0, 7]


def test_keys_and_fold_in_bit_equal():
    assert len(SEEDS) >= 50
    for s in SEEDS:
        k = jax.random.PRNGKey(s)
        kt = prng.prng_key(s)
        np.testing.assert_array_equal(kt.numpy(), u32(k))
        for d in (0, 1, 255, 1279, 2 ** 31 + 3):
            np.testing.assert_array_equal(
                prng.fold_in(kt, d).numpy(), u32(jax.random.fold_in(k, d)))


def test_batched_fold_in_matches_vmap():
    seeds = np.asarray(SEEDS[:16], np.int64)
    data = np.arange(16) * 97
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds & 0xFFFFFFFF,
                                                  jnp.uint32))
    want = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data))
    got = prng.fold_in(prng.prng_key(torch.tensor(seeds)),
                       torch.tensor(data))
    np.testing.assert_array_equal(got.numpy(), u32(want))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (97,)])
def test_bits_and_uniform_bit_equal(shape):
    for s in SEEDS[::4]:
        # one key per draw on both sides
        kb, ku, kg = (jax.random.fold_in(jax.random.PRNGKey(s), d)
                      for d in (1, 2, 3))
        tb, tu, tg = (prng.fold_in(prng.prng_key(s), d) for d in (1, 2, 3))
        np.testing.assert_array_equal(prng.random_bits(tb, shape).numpy(),
                                      u32(jax.random.bits(kb, shape)))
        np.testing.assert_array_equal(
            prng.uniform(tu, shape).numpy(),
            np.asarray(jax.random.uniform(ku, shape)))
        np.testing.assert_allclose(prng.gumbel(tg, shape).numpy(),
                                   np.asarray(jax.random.gumbel(kg, shape)),
                                   rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("vocab", [5, 97, 2049])
def test_categorical_draws_equal(vocab):
    rs = np.random.RandomState(vocab)
    seeds = np.asarray(SEEDS, np.int64)
    logits = rs.randn(len(seeds), vocab).astype(np.float32) * 3
    logits[:, ::3] = -np.finfo(np.float32).max      # masked entries
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds & 0xFFFFFFFF,
                                                  jnp.uint32))
    pos = np.arange(len(seeds)) + 256
    jf = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(pos))
    want = jax.vmap(jax.random.categorical)(jf, jnp.asarray(logits))
    kt = prng.fold_in(prng.prng_key(torch.tensor(seeds)), torch.tensor(pos))
    got = prng.categorical(kt, torch.tensor(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_takes_float32_only():
    """float32 and bfloat16 logits (the noise is drawn in their dtype);
    any other dtype is refused, as is a key batch that does not lead the
    logits."""
    with pytest.raises(TypeError):
        prng.categorical(prng.prng_key(0), torch.zeros(4,
                                                       dtype=torch.float16))
    with pytest.raises(ValueError, match="do not lead"):
        prng.categorical(prng.prng_key(torch.arange(3)), torch.zeros(2, 4))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (4, 97)])
def test_narrow_bits_and_bf16_uniform_bit_equal(shape):
    """16-bit words are the low half of JAX's partitionable 32-bit draw;
    a bfloat16 uniform takes 8 bits and keeps their top 7 (JAX draws 8
    bits for a type with fewer than 8 mantissa bits); the bfloat16
    Gumbel noise rounds each log to bfloat16, as XLA does: all exact."""
    for s in SEEDS[::4]:
        kb, ku, kg = (jax.random.fold_in(jax.random.PRNGKey(s), d)
                      for d in (1, 2, 3))
        tb, tu, tg = (prng.fold_in(prng.prng_key(s), d) for d in (1, 2, 3))
        np.testing.assert_array_equal(
            prng.random_bits(tb, shape, 16).numpy(),
            np.asarray(jax.random.bits(kb, shape, jnp.uint16)).astype(
                np.int64))
        got = prng.uniform(tu, shape, dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jax.random.uniform(ku, shape, jnp.bfloat16))
            .astype(np.float32))
        np.testing.assert_array_equal(
            prng.gumbel(tg, shape, torch.bfloat16).float().numpy(),
            np.asarray(jax.random.gumbel(kg, shape, jnp.bfloat16))
            .astype(np.float32))
