"""JAX's random streams in numpy: the keys and draws that name the JAX
trainer's initial network, so that one ``--seed`` builds one network in
both packages.

A key is a ``uint32[2]`` array, as ``jax.random.key_data`` gives it, of
the ``threefry2x32`` implementation with ``jax_threefry_partitionable``
on (JAX's default):

- :func:`key` is ``jax.random.PRNGKey``: ``[0, seed]``;
- :func:`fold_in`, :func:`split` and :func:`bits` are ``jax.random``'s:
  threefry2x32 of the key over the flat index of each element, a 64-bit
  count split into high and low words (JAX ``_src/prng.py``
  ``iota_2x32_shape``); ``bits`` is the XOR of the two output words;
- :func:`uniform` takes the top 23 bits as a mantissa in ``[1, 2)``,
  subtracts 1 and computes ``max(lo, f·(hi − lo) + lo)`` with one
  rounding, as XLA:CPU fuses it into a multiply-add;
- :func:`normal` is ``sqrt(2)·erfinv(u)`` for ``u`` uniform in
  ``[nextafter(−1, 0), 1)``, with XLA's single-precision ErfInv
  polynomial and XLA:CPU's own ``log1p`` (a Cephes rational below
  ``sqrt(2) − 1``, its vectorized ``log`` of ``1 + x`` above), each
  step rounded as the compiled code rounds it: a multiply feeding one add
  is one fused multiply-add;
- :func:`fold_in_static` is flax's per-parameter key
  (``flax/core/scope.py`` ``_fold_in_static``): the first 4 bytes,
  big-endian, of the SHA-1 of the module path and the scope's counter,
  folded into the key (flax's default: no separator bytes).

Every float step is float32 arithmetic, which numpy rounds as IEEE
prescribes, or a fused multiply-add emulated exactly in float64 (round to
odd, then to float32), so the draws do not depend on the host's libm.
Nothing here imports JAX.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import numpy as np

Key = np.ndarray  # uint32[2]
Shape = Tuple[int, ...]

_F32 = np.float32
_TINY32 = float(np.finfo(np.float32).tiny)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.uint32))


def threefry2x32(k: Key, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round threefry2x32 block of ``(x0, x1)`` under key ``k``."""
    k0, k1 = _u32(k[0]), _u32(k[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = _u32(x0) + ks[0], _u32(x1) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counts(shape: Shape) -> Tuple[np.ndarray, np.ndarray]:
    n = np.arange(math.prod(shape), dtype=np.uint64)
    return (n >> np.uint64(32)).astype(np.uint32), (n & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit ``seed``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    o0, o1 = threefry2x32(k, 0, int(data) & 0xFFFFFFFF)
    return np.concatenate([o0, o1])


def split(k: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: ``uint32[num, 2]``."""
    b0, b1 = threefry2x32(k, *_counts((num,)))
    return np.stack([b0, b1], axis=1)


def bits(k: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(k, shape)``: 32 random bits an element."""
    shape = tuple(shape)
    b0, b1 = threefry2x32(k, *_counts(shape))
    return (b0 ^ b1).reshape(shape)


def fma32(a, b, c) -> np.ndarray:
    """``a·b + c`` on float32 operands with one rounding to float32.  The
    product is exact in float64 and so is the sum's rounding to float32
    unless that sum, rounded to float64, sits on a float32 midpoint (or
    below float32's normal range); there the sum is rounded to odd (53
    bits, so rounding it again to 24 is the correctly rounded result)."""
    a, b, c = (np.atleast_1d(np.asarray(v, np.float32)).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    low = s.view(np.uint64) & np.uint64((1 << 29) - 1)
    i = np.nonzero((low == np.uint64(1 << 28)) | (np.abs(s) < _TINY32))
    if i[0].size:
        p, c, si = np.broadcast_to(p, s.shape)[i], np.broadcast_to(c, s.shape)[i], s[i]
        v = si - p
        err = (p - (si - v)) + (c - v)  # TwoSum: si + err == p + c exactly
        even = (si.view(np.int64) & 1) == 0
        step = np.where((err > 0) == (si > 0), 1, -1)
        s = s.copy()
        s[i] = np.where((err != 0) & even, (si.view(np.int64) + step).view(np.float64), si)
    return s.astype(np.float32)


def uniform(k: Key, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, lo, hi)``."""
    lo32, hi32 = _F32(lo), _F32(hi)
    mant = (bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = mant.view(np.float32) - _F32(1.0)
    return np.maximum(lo32, fma32(f, hi32 - lo32, lo32))


# Cephes' logf, as XLA:CPU vectorizes it (``log`` of the argument's
# mantissa in [sqrt(1/2), sqrt(2)) and its exponent).
_LOG_A = (_F32(0.070376836), _F32(-0.1151461), _F32(0.116769984))
_LOG_B = (_F32(-0.12420141), _F32(0.14249323), _F32(-0.16668057))
_LOG_C = (_F32(0.20000714), _F32(-0.24999994), _F32(0.3333333))
_LN2_HI, _LN2_LO = _F32(0.693359375), _F32(-0.00021219444)
_SQRT_HALF = _F32(0.70710677)
# log1p(x) for |x| < sqrt(2) - 1: x - x²/2 + x³·P(x)/Q(x) (Cephes).
_LOG1P_SMALL = _F32(0.41421357)
_LOG1P_P = tuple(map(_F32, (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
                            57.112965, 20.039553)))
_LOG1P_Q = tuple(map(_F32, (1.0, 15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
                            60.11866)))


def _log32(v: np.ndarray) -> np.ndarray:
    """XLA:CPU's float32 ``log`` of a positive finite ``v``."""
    vb = np.maximum(v, _F32(_TINY32)).view(np.uint32)
    e1 = ((vb >> np.uint32(23)).astype(np.int32) - 127).astype(np.float32) + _F32(1.0)
    m = ((vb & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    small = m < _SQRT_HALF
    t = (m - _F32(1.0)) + np.where(small, m, _F32(0.0))
    e1 = np.where(small, e1 - _F32(1.0), e1)
    t2 = t * t
    t3 = t2 * t
    a = fma32(fma32(t, _LOG_A[0], _LOG_A[1]), t, _LOG_A[2])
    b = fma32(fma32(t, _LOG_B[0], _LOG_B[1]), t, _LOG_B[2])
    c = fma32(fma32(t, _LOG_C[0], _LOG_C[1]), t, _LOG_C[2])
    poly = fma32(fma32(a, t3, b), t3, c)
    tail = fma32(poly, t3, e1 * _LN2_LO)
    head = fma32(-t2, _F32(0.5), t)
    return fma32(e1, _LN2_HI, head + tail)


def _log1p32(x: np.ndarray) -> np.ndarray:
    """XLA:CPU's float32 ``log1p`` of ``x`` in ``(-1, 0]``."""
    out = np.empty_like(x)
    small = np.abs(x) < _LOG1P_SMALL
    out[~small] = _log32(x[~small] + _F32(1.0))
    x = x[small]
    x2 = x * x
    p, q = _LOG1P_P[0], _LOG1P_Q[0]
    for cp, cq in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
        p, q = fma32(p, x, cp), fma32(q, x, cq)
    out[small] = x + fma32(x2, _F32(-0.5), (x * x2) * (p / q))
    return out


# XLA's ErfInv32 (Giles' single-precision approximation), w < 5 and w >= 5.
_ERFINV_LT5 = tuple(map(_F32, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                               -4.39150654e-06, 0.00021858087, -0.00125372503,
                               -0.00417768164, 0.246640727, 1.50140941)))
_ERFINV_GE5 = tuple(map(_F32, (-0.000200214257, 0.000100950558, 0.00134934322,
                               -0.00367342844, 0.00573950773, -0.0076224613,
                               0.00943887047, 1.00167406, 2.83297682)))


def erfinv32(u: np.ndarray) -> np.ndarray:
    """XLA:CPU's float32 ``erf_inv`` of ``u`` in ``(-1, 1)``."""
    u = np.asarray(u, np.float32)
    log = _log1p32(-(u * u))
    lt = log > _F32(-5.0)
    w = np.where(lt, _F32(-2.5) - log, np.sqrt(-log) + _F32(-3.0))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(w, p, np.where(lt, lo, hi))
    return u * p


def normal(k: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``."""
    u = uniform(k, shape, np.nextafter(_F32(-1.0), _F32(0.0)), 1.0)
    return erfinv32(u) * _F32(math.sqrt(2.0))


def he_normal_fan_out(k: Key, shape: Sequence[int]) -> np.ndarray:
    """flax ``variance_scaling(2.0, "fan_out", "normal")`` of an ``HWIO``
    kernel: ``normal · sqrt(float32(2 / (h·w·out)))``."""
    *receptive, _, out = shape
    std = np.sqrt(_F32(2.0 / (math.prod(receptive) * out)))
    return normal(k, shape) * std


def fold_in_static(k: Key, data: Sequence[Union[str, int]]) -> Key:
    """flax's ``_fold_in_static``: ``k`` folded with the first 4 bytes
    (big-endian) of the SHA-1 of ``data`` (strings as UTF-8, ints as their
    minimal big-endian bytes)."""
    if not data:
        return k
    h = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            h.update(x.encode("utf-8"))
        else:
            h.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return fold_in(k, int.from_bytes(h.digest()[:4], "big"))


def param_key(k: Key, path: Sequence[str], counter: int = 1) -> Key:
    """The key flax's ``init`` gives the ``counter``-th parameter that the
    module at ``path`` creates, from the ``params`` key ``k``."""
    return fold_in_static(k, (*path, counter))
