"""The fleet loop's per-step random stream, in plain PyTorch.

The reference draws per step with ``jax.random.fold_in(key, it)`` on
threefry and transforms with XLA's ``erf_inv``/``ndtri``; the port does not
reproduce those bits.  It draws from a counter-based generator instead,
written once here and once in ``csrc/fleet_loop.cu`` as the same sequence
of operations, so that the kernel and this plain version agree bit for bit
on the card:

  * :func:`philox4x32` — Philox4x32-10 (Salmon et al., SC'11) on int64
    tensors holding 32-bit words; key ``(lane seed, stream)``, counter
    ``(it, node, 0, 0)``;
  * :func:`uniform24` / :func:`uniform53` — words to floats in ``(0, 1]``
    (24 bits for float32, 53 for float64), exactly representable;
  * :func:`normal_f32` / :func:`normal_f64` — Box–Muller on two uniforms;
  * :func:`ndtri` — the inverse normal CDF by Wichura's algorithm AS241
    (PPND16), one written-out rational approximation in the working dtype.

Transcendentals (``log``, ``cos``, ``exp``) are torch's, which on the card
are the CUDA math library's, as in the kernel; ``sqrt`` and the divisions
are IEEE-rounded in both.  ``pow`` is not used: torch's float64 ``pow`` on
the card differs from the library's in the last bit on some inputs (H100,
torch 2.11), so :func:`root` forms ``u^e`` as ``exp(log(u)·e)`` in both.
No op here fuses a multiply into an add.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

# Streams: the second key word, one per kind of draw.
STREAM_JITTER = 0       # per node and step: the straggler jitter normal
STREAM_MAX = 1          # per step: the uniform of the inverse-CDF max
STREAM_EVICT = 2        # per step: the normal of an evicted node's new bias

TWO_PI = 2.0 * math.pi


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit words of ``a * m`` for 32-bit ``a`` and ``m``;
    ``a`` is split in 16-bit halves so no int64 product overflows."""
    t0 = (a & 0xFFFF) * m                       # < 2**48
    t1 = (a >> 16) * m                          # < 2**48
    s = t0 + ((t1 & 0xFFFF) << 16)              # < 2**49
    return (t1 >> 16) + (s >> 32), s & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on broadcastable int64 tensors of 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draw(seed: torch.Tensor, stream: int, it: torch.Tensor,
         node: torch.Tensor):
    """Four 32-bit words for counter ``(it, node, 0, 0)`` under key
    ``(seed, stream)``; arguments broadcast (int64 results)."""
    i64 = torch.int64
    z = torch.zeros((), dtype=i64, device=seed.device)
    k0 = seed.to(i64) & MASK32
    return philox4x32(it.to(i64), node.to(i64), z, z, k0,
                      torch.full((), stream, dtype=i64, device=seed.device))


def uniform24(w: torch.Tensor) -> torch.Tensor:
    """float32 in ``(0, 1]``: the top 24 bits of a word, plus one, × 2⁻²⁴."""
    return ((w >> 8) + 1).to(torch.float32) * 2.0 ** -24


def uniform53(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """float64 in ``(0, 1]``: 27 + 26 bits of two words, plus one, × 2⁻⁵³."""
    k = ((w0 >> 5) << 26) + (w1 >> 6)
    return (k + 1).to(torch.float64) * 2.0 ** -53


def normal_f32(w0, w1) -> torch.Tensor:
    """Box–Muller in float32 on two words."""
    u1, u2 = uniform24(w0), uniform24(w1)
    return torch.sqrt(torch.log(u1) * -2.0) * torch.cos(u2 * TWO_PI)


def normal_f64(w0, w1, w2, w3) -> torch.Tensor:
    """Box–Muller in float64 on four words."""
    u1, u2 = uniform53(w0, w1), uniform53(w2, w3)
    return torch.sqrt(torch.log(u1) * -2.0) * torch.cos(u2 * TWO_PI)


def uniform_min(w0, w1, dtype, minval: float) -> torch.Tensor:
    """Uniform in ``[minval, 1)`` of ``dtype``, as ``jax.random.uniform``
    forms it: ``max(minval, u·(1 - minval) + minval)`` with ``u`` in
    ``[0, 1)`` (24 bits for float32, 53 for float64)."""
    if dtype == torch.float32:
        u = (w0 >> 8).to(torch.float32) * 2.0 ** -24
    else:
        u = (((w0 >> 5) << 26) + (w1 >> 6)).to(torch.float64) * 2.0 ** -53
    return torch.clamp(u * (1.0 - minval) + minval, min=minval)


def root(u: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``u ** e`` for ``u`` in ``(0, 1]``, as ``exp(log(u)·e)``."""
    return torch.exp(torch.log(u) * e)


# AS241 (Wichura 1988, Appl. Statist. 37:477), PPND16.
_A = (3.3871328727963666080e0, 1.3314166789178437745e+2,
      1.9715909503065514427e+3, 1.3731693765509461125e+4,
      4.5921953931549871457e+4, 6.7265770927008700853e+4,
      3.3430575583588128105e+4, 2.5090809287301226727e+3)
_B = (1.0, 4.2313330701600911252e+1, 6.8718700749205790830e+2,
      5.3941960214247511077e+3, 2.1213794301586595867e+4,
      3.9307895800092710610e+4, 2.8729085735721942674e+4,
      5.2264952788528545610e+3)
_C = (1.42343711074968357734e0, 4.63033784615654529590e0,
      5.76949722146069140550e0, 3.64784832476320460504e0,
      1.27045825245236838258e0, 2.41780725177450611770e-1,
      2.27238449892691845833e-2, 7.74545014278341407640e-4)
_D = (1.0, 2.05319162663775882187e0, 1.67638483018380384940e0,
      6.89767334985100004550e-1, 1.48103976427480074590e-1,
      1.51986665636164571966e-2, 5.47593808499534494600e-4,
      1.05075007164441684324e-9)
_E = (6.65790464350110377720e0, 5.46378491116411436990e0,
      1.78482653991729133580e0, 2.96560571828504891230e-1,
      2.65321895265761230930e-2, 1.24266094738807843860e-3,
      2.71155556874348757815e-5, 2.01033439929228813265e-7)
_F = (1.0, 5.99832206555887937690e-1, 1.36929880922735805310e-1,
      1.48753612908506148525e-2, 7.86869131145613259100e-4,
      1.84631831751005468180e-5, 1.42151175831644588870e-7,
      2.04426310338993978564e-15)


def _horner(coef, r):
    """``((c7·r + c6)·r + …)·r + c0``: one multiply and one add a term."""
    acc = r * coef[7] + coef[6]
    for c in coef[5::-1]:
        acc = acc * r + c
    return acc


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """Inverse of the standard normal CDF (AS241), in ``p``'s dtype;
    ``-inf`` at 0 and ``+inf`` at 1."""
    q = p - 0.5
    r = 0.180625 - q * q
    central = q * _horner(_A, r) / _horner(_B, r)
    r = torch.sqrt(-torch.log(torch.where(q < 0.0, p, 1.0 - p)))
    near = r - 1.6
    far = r - 5.0
    tail = torch.where(r <= 5.0, _horner(_C, near) / _horner(_D, near),
                       _horner(_E, far) / _horner(_F, far))
    tail = torch.where(q < 0.0, -tail, tail)
    out = torch.where(torch.abs(q) <= 0.425, central, tail)
    out = torch.where(p <= 0.0, -math.inf, out)
    return torch.where(p >= 1.0, math.inf, out)
