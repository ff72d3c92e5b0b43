"""Counter-based random numbers, bit-equal to the `jax.random` calls of the
reference renderer (`PRNGKey`, `split`, `uniform` for float32).

The reference draws its AO, diffuse and path directions with jax's
threefry2x32 under `jax_threefry_partitionable=True` (the default of the
jax the reference runs on). This module repeats that arithmetic:
  - `key_words(seed)` is `_threefry_seed`: the key (seed >> 32, seed & M)
    for a seed in the int32 range (jax's default int32 seed: hi word 0);
  - `threefry2x32` is `_threefry2x32_lowering`: 20 rounds with the
    rotations (13, 15, 26, 6) and (17, 29, 16, 24) and a key injection
    after every four;
  - `split_words(key)` is `_threefry_split_foldlike` into two: the hash of
    the counter pairs (0, 0) and (0, 1);
  - `uniform(key, shape)` is `_threefry_random_bits_partitionable` (the
    hash of the counters (i >> 32, i & M) of the row-major index i, then
    bits1 ^ bits2) followed by `random._uniform` (the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled to [0, 1), max with 0).
A key is its two uint32 words on the host, as Python integers: no key is
uploaded and none read back. The bits live in int64 tensors, because
torch's uint32 has too few operations, and every step masks to 32 bits.
tests/test_torch_secondary.py holds the results to jax bit for bit;
csrc/secondary_rays.cu repeats `uniform` in uint32 arithmetic.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key_words(seed: int) -> tuple[int, int]:
    """The two uint32 words of jax.random.PRNGKey(seed), on the host."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return 0, seed & _M32


def prng_key(seed: int, device=None) -> tuple[int, int]:
    """key_words(seed), under jax's name, which the benchmark's own tests
    call with a device; keys live on the host, so `device` is unused."""
    return key_words(seed)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1: int | torch.Tensor, k2: int | torch.Tensor,
                 x0: int | torch.Tensor, x1: int | torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1) under the key (k1, k2);
    every operand holds uint32 values, in int64 tensors or Python ints."""
    ks = [k1, k2, k1 ^ k2 ^ _PARITY]
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _counters(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split_words(words: tuple[int, int]):
    """jax.random.split(key) of the key whose host words are `words`, as
    host words: (the key that goes on, the key that draws). Plain Python
    integers: no tensor, no device."""
    return tuple(threefry2x32(words[0], words[1], 0, i) for i in range(2))


def random_bits32(key: tuple[int, int], shape, device=None) -> torch.Tensor:
    """32 random bits per element of `shape` (int64 holding uint32) on
    `device` (torch's default where None), from the host words `key`."""
    k1, k2 = key
    n = 1
    for s in shape:
        n *= int(s)
    hi, lo = _counters(n, device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: tuple[int, int], shape, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) on [0, 1); `key` and
    `device` as in random_bits32."""
    bits = random_bits32(key, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)
