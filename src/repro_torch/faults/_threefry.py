"""The port's copy of the `jax.random` primitives the drop plan draws from.

`DropPlan.mask` must give, bit for bit, the masks of the reference's
`jax.random.bernoulli(fold_in(fold_in(PRNGKey(seed), layer), t), keep_p)`
under jax's default threefry2x32 implementation with partitionable bits
(`jax_threefry_partitionable`):

* `threefry2x32` — 20 rounds, rotations (13, 15, 26, 6) and
  (17, 29, 16, 24), key parity 0x1BD11BDA, a key injection after every
  four rounds;
* `prng_key(seed)` — the key `[seed >> 32, seed & 0xFFFFFFFF]`;
* `fold_in(key, d)` — `threefry2x32(key, (0, d))`, d as uint32;
* `random_bits(key, n)` — element i hashes the counter (i >> 32,
  i & 0xFFFFFFFF) and keeps the XOR of the two output words;
* `uniform(bits)` — `(bits >> 9) | 0x3F800000` read as f32, minus 1;
* `bernoulli(key, p)` — `uniform < p` in f32 (jax's default 'low' mode).

torch has no shifts for unsigned 32-bit integers, so every word lives in
an int64 tensor and is masked to 32 bits after each add and rotate; the
f32 bitcast goes through an int32 view.  The same code runs on the CPU
and on the card and gives the same bits on both.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 hash of the counter words (x0, x1) under `key`.

    `key` is a pair of uint32 words (ints, or int64 tensors that broadcast
    against the counters); returns the two output words as int64 tensors
    holding uint32 values.
    """
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2**64."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"key seed {seed} outside [0, 2**64)")
    return (torch.tensor(seed >> 32, dtype=torch.int64, device=device),
            torch.tensor(seed & _M32, dtype=torch.int64, device=device))


def fold_in(key, data) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.random.fold_in(key, data)`; `data` is an int or an int64
    tensor of values in [0, 2**32), one folded key per element."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key[0].device)
    return threefry2x32(key, torch.zeros_like(data), data & _M32)


def random_bits(key, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,))` as int64 uint32 values; key words of
    shape (R, 1) give (R, n), one row per key."""
    idx = torch.arange(n, dtype=torch.int64, device=key[0].device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & _M32)
    return y0 ^ y1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """jax's f32 uniform in [0, 1) from 32 random bits."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def bernoulli(key, p: torch.Tensor) -> torch.Tensor:
    """`jax.random.bernoulli(key, p)` (mode 'low') over the last axis of
    f32 `p`, as a bool tensor."""
    return uniform(random_bits(key, int(p.shape[-1]))) < p
