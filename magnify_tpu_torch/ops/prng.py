"""Counter-based threefry2x32 random streams, bit-identical to ``jax.random``.

The RANSAC sampler of the JAX package draws its edge pixels and in-cell
neighbours from ``jax.random`` with the default threefry2x32 implementation
and partitionable key derivation (``jax_threefry_partitionable``, the
default of JAX 0.5 and later). The same seed must give the same proposals
here, so this module computes the same bits:

* :func:`prng_key` is ``jax.random.PRNGKey(seed)``: the key words
  ``(seed >> 32, seed & 0xFFFFFFFF)`` of a 32-bit seed, so ``(0, seed)``;
* :func:`split` hashes the counters ``(0, i)`` for ``i < n``: key ``i`` is
  the hash's word pair;
* :func:`random_bits` hashes the counters ``(0, i)`` and XORs the two words;
* :func:`randint` draws two such streams from ``split(key, 2)`` and folds
  ``hi * 2^32 + lo`` into ``[minval, maxval)`` with JAX's multiply-mod
  recipe (``(hi % span) * ((2^16 % span)^2 % span) + lo % span``, every
  product and sum wrapping in uint32 as XLA's do: for a span above 2^16
  the square of ``2^16`` wraps to 0);
* :func:`uniform` puts the top 23 bits into the mantissa of a float in
  ``[1, 2)`` and subtracts one.

Every word is held in an int64 tensor masked to 32 bits, so the hash runs
the same on the CPU and on a card. A key is a (2,) int64 tensor; a batch of
keys (..., 2) (the rows of :func:`split`) gives a batch of streams (..., n),
row for row what each key gives alone, as ``jax.vmap`` would.
"""

from __future__ import annotations

import torch

__all__ = ["prng_key", "randint", "random_bits", "split", "threefry2x32",
           "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``: int64 tensors (or ints) holding uint32
    values, broadcast together. Returns the two output words."""
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=x1.device)
    k2 = torch.as_tensor(k2, dtype=torch.int64, device=x1.device)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed that fits int32."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _counters(n, device) -> torch.Tensor:
    """The counters ``0 .. n - 1`` of an int ``n``, or ``n`` itself: a 1-D
    int64 tensor of counters, a slice of a longer stream (each draw depends
    on its counter alone, so ``n[k]`` draws what draw ``n[k]`` of the whole
    stream draws). The caller keeps tensor counters below 2^32."""
    if isinstance(n, torch.Tensor):
        if n.ndim != 1 or n.dtype != torch.int64:
            raise TypeError("counters must be a 1-D int64 tensor")
        return n.to(device)
    if n >= 2**32:
        raise ValueError(f"{n} draws exceed the 32-bit counter")
    return torch.arange(n, dtype=torch.int64, device=device)


def _hash_counters(key: torch.Tensor, n):
    lo = _counters(n, key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo),
                        lo)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (..., n, 2) keys."""
    a, b = _hash_counters(key, n)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, n) -> torch.Tensor:
    """(..., n) uint32 words of ``jax.random.bits(key, (n,))`` (as int64).
    ``n`` may also be a 1-D int64 tensor of counters (:func:`_counters`):
    the words of those draws of the stream."""
    a, b = _hash_counters(key, n)
    return a ^ b


def randint(key: torch.Tensor, n, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` for int32 bounds
    (python ints or int tensors that broadcast against (..., 1)): (..., n)
    int32 in ``[minval, maxval)``, or ``minval`` where ``maxval <=
    minval``. ``n`` may be a tensor of counters, as for
    :func:`random_bits`."""
    dev = key.device
    minval = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], n)
    lo = random_bits(keys[..., 1, :], n)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & _MASK)
    mult = (2**16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    off = (off & _MASK) % span
    return (minval + off).to(torch.int32)


def uniform(key: torch.Tensor, n) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32)``: (..., n) f32 in [0,
    1). ``n`` may be a tensor of counters, as for :func:`random_bits`."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
