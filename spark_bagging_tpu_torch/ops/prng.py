"""The threefry-2x32 key schedule of ``jax.random``, in torch.

The bootstrap of the JAX package draws every replica's row weights from
``jax.random`` keys. To reproduce those draws bit for bit the port
carries its own threefry-2x32 hash and the parts of ``jax.random`` the
bootstrap uses: ``key``, ``fold_in``, ``split``, the *partitionable*
random-bits layout (``jax_threefry_partitionable``, the default from
jax 0.5 on), ``uniform`` and ``normal`` for float32, ``randint`` for
int32 and ``permutation`` of a range.

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
    if isinstance(data, int):
        # filled on the device: a tensor made from a Python int would be
        # copied from the host, which waits for the device's queue
        data = torch.full((), data & _M32, dtype=torch.int64, device=k.device)
    else:
        data = torch.as_tensor(data, dtype=torch.int64,
                               device=k.device) & _M32
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


# XLA's float32 ``erf_inv`` (Giles' single-precision approximation):
# coefficients of the polynomial in w for w < 5 and for w >= 5
_ERF_INV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` as XLA computes it, not ``torch.erfinv``:
    the two approximations differ by up to ~90 ulps in the tails, and
    JAX's normals are made by XLA's. Each Horner step ``c + p * w`` is
    rounded once, as the fused multiply-add XLA's CPU code uses."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = None
    for a, b in zip(_ERF_INV_W_LT_5, _ERF_INV_W_GE_5):
        c = torch.where(lt, np.float32(a).item(), np.float32(b).item())
        p = c if p is None else (c.double() + p.double() * w).float()
    big = torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1, x * big, p * x)


def normal(k: torch.Tensor, shape: int | tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``, shape ``(..., *shape)``:
    a uniform on ``[nextafter(-1, 0), 1)`` from the same bits as
    :func:`uniform`, then ``sqrt(2) * erf_inv(u)`` with XLA's
    ``erf_inv`` polynomial. The uniform is bitwise JAX's; the normals
    agree to a few ulps, since ``log1p`` differs in its last bits
    (tests/test_torch_mlp.py states how many)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    bits = (random_bits(k, math.prod(shape)) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    # (1 - lo) rounds to 2 in float32, and f * 2 is exact
    u = torch.clamp_min(f * 2.0 + lo, lo)
    out = _erf_inv(u) * np.float32(np.sqrt(2)).item()
    return out.reshape(*k.shape[:-1], *shape)


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
