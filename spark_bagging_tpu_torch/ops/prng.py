"""The threefry-2x32 key schedule of ``jax.random``, in torch.

The bootstrap of the JAX package draws every replica's row weights from
``jax.random`` keys. To reproduce those draws bit for bit the port
carries its own threefry-2x32 hash and the parts of ``jax.random`` the
bootstrap uses: ``key``, ``fold_in``, ``split``, the *partitionable*
random-bits layout (``jax_threefry_partitionable``, the default from
jax 0.5 on), ``uniform`` and ``normal`` for float32, ``randint`` for
int32, ``permutation`` of a range and ``poisson``'s rejection sampler
for rates of 10 and more.

A key is an int64 tensor of shape ``(..., 2)`` holding the two uint32
words of a JAX key (``jax.random.key_data``). uint32 arithmetic is done
in int64 and masked to ``0xFFFFFFFF``; leading key dimensions batch, so
one call draws for a whole chunk of replicas. This is plain tensor code
and runs on whichever device the key lies on.
"""

from __future__ import annotations

import math
import struct

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


# -- jax.random.poisson's transformed rejection (Hoermann), rates >= 10 --
#
# Each round accepts or rejects through ``s <= t``, and a last-bit
# difference in either side flips a draw. So the two are computed as
# XLA's CPU code computes them, from IEEE operations that round the same
# on the CPU and on the card: its float32 ``log`` (Cephes' polynomial),
# ``log1p`` and ``lgamma`` (the Lanczos sum), with the multiply-adds its
# code generator fuses done as one rounding (:func:`_fma32`).

def _f32(hex64: str) -> float:
    """A float32 constant from the 64-bit hex form LLVM prints it in."""
    return float(np.float32(struct.unpack(">d", bytes.fromhex(hex64))[0]))


_LOG_P = tuple(_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
_LOG_SQRTHF = _f32("3FE6A09E60000000")
_LOG_Q1 = _f32("BF2BD01060000000")
_LOG_Q2 = _f32("3FE6300000000000")
_FLT_MIN = float(np.finfo(np.float32).tiny)
# log1p's rational approximation below |x| < sqrt(2) - 1
_LOG1P_DEN = tuple(_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000"))
_LOG1P_NUM = tuple(_f32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000"))
_LOG1P_SMALL = _f32("3FDA8279A0000000")
_LANCZOS = tuple(float(np.float32(c)) for c in (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7))
_LANCZOS_G = 7.5                                   # lanczos gamma + 1/2
_INV_LANCZOS_G = float(np.float32(1 / np.float32(7.5)))
_LOG_LANCZOS_G = float(np.float32(np.log(7.5)))
_LOG_SQRT_2PI = float(np.float32(0.91893853320467274178))


def _fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, so only the sum rounds (to float64,
    then float32; a double rounding that is off only when the float64
    sum lands exactly halfway between two floats)."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else x
               for x in (a, b, c))
    return (a * b + c).float()


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor: ``v / t`` of a Python float is computed as
    ``t.reciprocal() * v``, two roundings; a tensor numerator divides."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA's CPU code computes it (``jnp.log``):
    Cephes' ``logf`` polynomial on the mantissa in [sqrt(1/2), sqrt(2)),
    with the multiply-adds fused. ``torch.log`` differs from it in the
    last bit for about one input in six."""
    xm = torch.clamp_min(x, _FLT_MIN)
    bits = xm.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _LOG_SQRTHF
    r = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.to(torch.float32)
    r2 = r * r
    r3 = r2 * r
    p = _LOG_P
    y = _fma32(_fma32(r, p[0], p[1]), r, p[2])
    y1 = _fma32(_fma32(r, p[3], p[4]), r, p[5])
    y2 = _fma32(_fma32(r, p[6], p[7]), r, p[8])
    y = _fma32(_fma32(_fma32(y, r3, y1), r3, y2), r3, e * _LOG_Q1)
    out = _fma32(e, _LOG_Q2, _fma32(r2, -0.5, r) + y)
    out = torch.where((x < 0) | torch.isnan(x), math.nan, out)
    out = torch.where(x == 0, -math.inf, out)
    return torch.where(x == math.inf, x, out)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA's CPU code computes it: ``log(1 + x)``,
    and a rational approximation where ``|x| < sqrt(2) - 1``."""
    x2 = x * x
    den = torch.ones_like(x)
    for c in _LOG1P_DEN:
        den = _fma32(den, x, c)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma32(num, x, c)
    near = x + _fma32(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, near, xla_log(x + 1.0))


def _lgamma_1p(k: torch.Tensor) -> torch.Tensor:
    """``lgamma(k + 1)`` for ``k >= 0`` as XLA computes ``lax.lgamma``
    in float32: the Lanczos sum, with ``(k + 1) - 1`` simplified to
    ``k`` and the division by 7.5 turned into a product, as XLA does."""
    z = k
    log_t = _xla_log1p(z * _INV_LANCZOS_G) + _LOG_LANCZOS_G
    acc = _scalar(_LANCZOS[0], z) / (z + 1.0) + 1.0
    for i, c in enumerate(_LANCZOS[1:], start=2):
        acc = acc + _scalar(c, z) / (z + float(i))
    log_y = _fma32((z + 0.5) - (z + _LANCZOS_G) / log_t, log_t,
                   _LOG_SQRT_2PI)
    return log_y + xla_log(acc)


def _rejection_constants(lam: float) -> tuple[float, ...]:
    """The per-rate constants of the rejection sampler, on the host:
    ``(lam, log lam, b, a, 1/alpha, v_r)`` in float32."""
    f = lambda v: float(np.float32(v))  # noqa: E731
    lam32 = np.float32(lam)
    log_lam = float(xla_log(torch.tensor([lam32]))[0])
    sq = float(np.sqrt(lam32))  # correctly rounded; torch.sqrt is not
    b = float(_fma32(torch.tensor(f(2.53)), sq, f(0.931)))
    a = float(_fma32(torch.tensor(f(0.02483)), b, f(-0.059)))
    inv_alpha = f(np.float32(1.1239) + np.float32(1.1328)
                  / (np.float32(b) - np.float32(3.4)))
    v_r = f(np.float32(0.9277) - np.float32(3.6224)
            / (np.float32(b) - np.float32(2)))
    return float(lam32), log_lam, b, a, inv_alpha, v_r


def poisson(k: torch.Tensor, lam: float, n: int) -> torch.Tensor:
    """``jax.random.poisson(k, lam, (n,))`` for a rate ``lam >= 10``,
    shape ``(..., n)`` float32 counts: Hoermann's transformed rejection,
    JAX's branch for such rates.

    Each round splits every key in three, draws ``u`` and ``v`` and
    accepts a row by ``accept1 | (~reject & (s <= t))``; a row accepted
    again in a later round takes the later value, as JAX's loop does.
    Each key (a replica under ``vmap``) loops until all of its own rows
    have accepted and then stays frozen while the others go on."""
    if not lam >= 10:
        raise ValueError(f"poisson's rejection sampler needs lam >= 10, "
                         f"got {lam}")
    lam, log_lam, b, a, inv_alpha, v_r = _rejection_constants(lam)
    f = lambda v: float(np.float32(v))  # noqa: E731
    lead = k.shape[:-1]
    keys = k.reshape(-1, 2).clone()
    out = torch.full((keys.shape[0], n), -1.0, device=k.device)
    accepted = torch.zeros((keys.shape[0], n), dtype=torch.bool,
                           device=k.device)
    two_a = _scalar(2 * a, out)
    a_t = _scalar(a, out)
    while True:
        live = (~accepted).any(dim=1).nonzero().squeeze(1)
        if live.numel() == 0:
            break
        sub = split(keys[live], 3)
        u = uniform(sub[:, 1], n) - 0.5
        v = uniform(sub[:, 2], n)
        us = 0.5 - u.abs()
        cand = torch.floor(_fma32(two_a / us + b, u, lam) + f(0.43))
        s = xla_log((v * inv_alpha) / (a_t / (us * us) + b))
        t = _fma32(cand, log_lam, -lam) - _lgamma_1p(cand.clamp_min(0.0))
        accept = (((us >= f(0.07)) & (v <= v_r))
                  | (~((cand < 0) | ((us < f(0.013)) & (v > us)))
                     & (s <= t)))
        out[live] = torch.where(accept, cand, out[live])
        accepted[live] |= accept
        keys[live] = sub[:, 0]
    return out.reshape(*lead, n)
