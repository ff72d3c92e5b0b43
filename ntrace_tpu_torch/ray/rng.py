"""Counter-based random numbers, bit-equal to the `jax.random` calls of the
reference renderer (`PRNGKey`, `split`, `uniform` for float32).

The reference draws its AO, diffuse and path directions with jax's
threefry2x32 under `jax_threefry_partitionable=True` (the default of the
jax the reference runs on). This module repeats that arithmetic:
  - `prng_key(seed)` is `_threefry_seed`: the key (seed >> 32, seed & M)
    for a seed in the int32 range (jax's default int32 seed: hi word 0);
  - `threefry2x32` is `_threefry2x32_lowering`: 20 rounds with the
    rotations (13, 15, 26, 6) and (17, 29, 16, 24) and a key injection
    after every four;
  - `split(key, n)` is `_threefry_split_foldlike`: the hash of the counter
    pairs (0, i), stacked;
  - `uniform(key, shape)` is `_threefry_random_bits_partitionable` (the
    hash of the counters (i >> 32, i & M) of the row-major index i, then
    bits1 ^ bits2) followed by `random._uniform` (the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled to [0, 1), max with 0).
torch's uint32 has too few operations, so the words live in int64 and
every step masks to 32 bits. Keys are (2,) int64 tensors holding the
uint32 values. tests/test_torch_secondary.py holds the results to jax bit
for bit.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int, device) -> torch.Tensor:
    """jax.random.PRNGKey(seed) as a (2,) int64 tensor of uint32 words on
    `device`; split and uniform follow the key's device."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1: int | torch.Tensor, k2: int | torch.Tensor,
                 x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1) under the key (k1, k2);
    every operand holds uint32 values in int64."""
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


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): (num, 2) int64 keys."""
    k1, k2 = (int(w) for w in key.tolist())
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=1)


def random_bits32(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of `shape` (int64 holding uint32)."""
    k1, k2 = (int(w) for w in key.tolist())
    n = 1
    for s in shape:
        n *= int(s)
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) on [0, 1)."""
    bits = random_bits32(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)
