"""The port's threefry streams (``magnify_tpu_torch.ops.prng``) against
``jax.random``, bit for bit.

The RANSAC sampler of the JAX package draws from ``jax.random`` with the
default threefry2x32 implementation and partitionable key derivation; the
port reproduces those bits with int64 tensor arithmetic. Every case feeds
the same key to both and compares the raw words: keys from ``PRNGKey`` for
several seeds, ``split`` into 3, 64 and 1,568 keys (the per-chamber keys of
frame C), ``randint`` with spans below, at and above 2^16 (where the
multiply-mod recipe's uint32 products wrap) and ``uniform``, at 1, 1,000 and
2^17 + 5 draws, and batches of keys as ``jax.vmap`` draws them. The JAX
side runs jitted.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from magnify_tpu_torch.ops import prng  # noqa: E402

SEEDS = (0, 1, 42, 2**31 - 1)
SIZES = (1, 1000, 2**17 + 5)


# One intra-op thread per test process: the suite runs several pytest
# workers at once, and oversubscribed torch thread pools spin for the cores
# the others need.
torch.set_num_threads(1)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", (3, 64, 1568))
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_split_matches(seed, n):
    want = jax.jit(jax.random.split, static_argnums=1)(
        jax.random.PRNGKey(seed), n)
    np.testing.assert_array_equal(prng.split(prng.prng_key(seed), n).numpy(),
                                  _words(want))


@functools.lru_cache(maxsize=None)
def _jax_randint(size):
    """One jitted draw per size; ``maxval`` is traced."""
    return jax.jit(lambda k, m: jax.random.randint(k, (size,), 0, m))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("maxval", (1, 7, 2**20 + 3, 2**24))
def test_randint_matches(maxval, size):
    key = jax.random.split(jax.random.PRNGKey(5), 3)[0]
    want = _jax_randint(size)(key, jnp.int32(maxval))
    got = prng.randint(torch.as_tensor(_words(key)), size, 0, maxval)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", SIZES)
def test_uniform_matches(size):
    key = jax.random.split(jax.random.PRNGKey(9), 3)[1]
    want = jax.jit(lambda k: jax.random.uniform(k, (size,), jnp.float32))(key)
    got = prng.uniform(torch.as_tensor(_words(key)), size)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_key_batches_match_vmap():
    """A batch of keys (the per-chamber keys) draws, row for row, what each
    key draws alone, as ``jax.vmap`` does; ``maxval`` per row, one of them
    0 (an empty chamber: every draw is 0)."""
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    tkeys = prng.split(prng.prng_key(0), 5)
    maxval = np.array([1, 7, 100, 2**20 + 3, 0], np.int32)
    want = jax.jit(jax.vmap(lambda k, m: jax.random.randint(k, (33,), 0, m)))(
        keys, jnp.asarray(maxval))
    got = prng.randint(tkeys, 33, 0, torch.as_tensor(maxval)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_u = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (33,))))(keys)
    np.testing.assert_array_equal(prng.uniform(tkeys, 33).numpy().view(
        np.int32), np.asarray(want_u).view(np.int32))
    want_k = jax.jit(jax.vmap(lambda k: jax.random.split(k, 3)))(keys)
    np.testing.assert_array_equal(prng.split(tkeys, 3).numpy(),
                                  _words(want_k))
