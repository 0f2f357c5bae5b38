"""The threefry-2x32 key schedule of ``jax.random``, in torch.

The bootstrap of the JAX package draws every replica's row weights from
``jax.random`` keys. To reproduce those draws bit for bit the port
carries its own threefry-2x32 hash and the parts of ``jax.random`` the
bootstrap uses: ``key``, ``fold_in``, ``split``, the *partitionable*
random-bits layout (``jax_threefry_partitionable``, the default from
jax 0.5 on), ``uniform`` for float32, ``randint`` for int32 and
``permutation`` of a range.

A key is an int64 tensor of shape ``(..., 2)`` holding the two uint32
words of a JAX key (``jax.random.key_data``). uint32 arithmetic is done
in int64 and masked to ``0xFFFFFFFF``; leading key dimensions batch, so
one call draws for a whole chunk of replicas. This is plain tensor code
and runs on whichever device the key lies on.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2); all int64 tensors holding uint32 values,
    broadcast together."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _M32
    x2 = (x2 + k2) & _M32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(block + 1) % 3]) & _M32
        x2 = (x2 + ks[(block + 2) % 3] + block + 1) & _M32
    return x1, x2


def key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` in JAX's default
    32-bit mode: ``(0, seed mod 2**32)``, the seed's low 32 bits, for
    any Python int."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``.

    ``k`` is ``(..., 2)``; ``data`` an int or an integer tensor that
    broadcasts against ``k[..., 0]`` (one key per entry of ``data``).
    """
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _M32
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable layout): ``(..., num, 2)``."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(
        k[..., 0, None], k[..., 1, None], torch.zeros_like(lo), lo
    )
    return torch.stack([b1, b2], dim=-1)


def random_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element, shape ``(..., n)``: the partitionable
    layout hashes the 64-bit element index split into (hi, lo) words and
    xors the two output words. A draw of shape ``(a, b)`` hashes the
    row-major flat index, so it is this draw of ``a * b`` reshaped."""
    if n >= 2 ** 32:
        raise ValueError("at most 2**32 - 1 draws per key")
    lo = torch.arange(n, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(
        k[..., 0, None], k[..., 1, None], torch.zeros_like(lo), lo
    )
    return b1 ^ b2


def uniform(k: torch.Tensor, shape: int | tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` in [0, 1), shape
    ``(..., *shape)``: the top 23 bits become the mantissa of a float in
    [1, 2), minus 1."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    bits = (random_bits(k, math.prod(shape)) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u, 0.0).reshape(*k.shape[:-1], *shape)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``, shape ``(..., n)`` int64: JAX's
    ``_shuffle``, which per round splits the key, draws 32 random bits
    per element from the second half and stably sorts by them. The
    round count is JAX's, ``ceil(3 ln n / ln(2**32 - 1))``: one round
    up to ~1.6M elements."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_M32)))
    perm = torch.arange(n, dtype=torch.int64, device=k.device)
    perm = perm.expand(*k.shape[:-1], n)
    for _ in range(rounds):
        keys = split(k, 2)
        k, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        perm = torch.gather(perm, -1, order)
    return perm


def randint(k: torch.Tensor, n: int, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, (n,), minval, maxval, int32)`` for int32
    bounds: two 32-bit draws per element folded into the span by JAX's
    uint32 modular arithmetic, whose products and sums wrap mod 2**32
    (masked here after each step)."""
    span = maxval - minval
    if span <= 0:
        return torch.full(
            (*k.shape[:-1], n), minval, dtype=torch.int32, device=k.device
        )
    if not -(2 ** 31) <= minval < maxval < 2 ** 31:
        raise ValueError(f"randint bounds [{minval}, {maxval}) exceed int32")
    keys = split(k, 2)
    higher = random_bits(keys[..., 0, :], n)
    lower = random_bits(keys[..., 1, :], n)
    half = 2 ** 16 % span
    multiplier = ((half * half) & _M32) % span  # 0 once span > 2**16
    offset = (((higher % span) * multiplier) & _M32) + lower % span
    offset = (offset & _M32) % span
    return (offset + minval).to(torch.int32)
