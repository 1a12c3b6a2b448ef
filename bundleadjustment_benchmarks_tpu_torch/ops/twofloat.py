"""Double-single ("two-float", df32) arithmetic on float32 tensors.

A value is the unevaluated sum hi + lo of two float32 numbers with
non-overlapping mantissas, which keeps ~48 bits of precision at float32
speed (Dekker 1971, Knuth TwoSum). The df32 geometry drive uses it for the
world->camera transform, whose far-field cancellation (|R X| ~ 1e4 against
z ~ 4) a plain float32 product cannot survive, and for the energy sums.

Every function is a sequence of single tensor ops: each op rounds once, so
nothing is contracted into a fused multiply-add. The CUDA kernels in
``csrc/chain_math.cuh`` repeat the same sequences with contraction off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DF(NamedTuple):
    """A two-float number: value = hi + lo."""

    hi: torch.Tensor
    lo: torch.Tensor


# -- Error-free transformations ------------------------------------------------


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Dekker FastTwoSum, requires |a| >= |b|: s + e == a + b exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


#: Dekker split constant for float32 (2^12 + 1).
_SPLIT_F32 = 4097.0


def split(a):
    """Dekker split: a == hi + lo with at most 12 mantissa bits each."""
    t = a * _SPLIT_F32
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (no fused multiply-add)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- DF arithmetic --------------------------------------------------------------


def add(x: DF, y: DF) -> DF:
    """DF + DF (sloppy double-single add; ~2^-48 relative)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DF(*quick_two_sum(s, e))


def add_f(x: DF, b) -> DF:
    """DF + plain float tensor."""
    s, e = two_sum(x.hi, b)
    e = e + x.lo
    return DF(*quick_two_sum(s, e))


def mul(x: DF, y: DF) -> DF:
    """DF * DF."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DF(*quick_two_sum(p, e))


def prod_ff(a, b) -> DF:
    """Exact product of two float tensors as a DF."""
    return DF(*two_prod(a, b))


# -- Conversions ----------------------------------------------------------------


def from_f64(x: torch.Tensor) -> DF:
    """Split a float64 tensor exactly into a float32 DF pair."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return DF(hi, lo)


def from_f32(x: torch.Tensor) -> DF:
    return DF(x, torch.zeros_like(x))


def from_array(x: torch.Tensor) -> DF:
    """Split float64 exactly; promote float32 with a zero low part."""
    if x.dtype == torch.float64:
        return from_f64(x)
    return from_f32(x)


def to_f64(x: DF) -> torch.Tensor:
    return x.hi.to(torch.float64) + x.lo.to(torch.float64)


def to_f32(x: DF) -> torch.Tensor:
    # hi and lo do not overlap: hi + lo rounds to hi in float32.
    return x.hi


# -- Reductions ------------------------------------------------------------------


def sum_df(x: DF, dim=None) -> DF:
    """Compensated sum of a DF tensor by a power-of-two pairwise tree.

    The reduced axis is zero-padded to the next power of two and halved with
    DF adds (first half + second half) until one element remains: the same
    tree as the reference's ``twofloat.sum_df``, so the plain energies agree
    with it term for term.
    """
    hi, lo = x.hi, x.lo
    if dim is None:
        hi, lo, dim = hi.reshape(-1), lo.reshape(-1), 0
    hi = torch.movedim(hi, dim, 0)
    lo = torch.movedim(lo, dim, 0)
    n = hi.shape[0]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        pad = hi.new_zeros((m - n,) + tuple(hi.shape[1:]))
        hi = torch.cat([hi, pad])
        lo = torch.cat([lo, pad])
    cur = DF(hi, lo)
    while cur.hi.shape[0] > 1:
        half = cur.hi.shape[0] // 2
        cur = add(DF(cur.hi[:half], cur.lo[:half]),
                  DF(cur.hi[half:], cur.lo[half:]))
    return DF(cur.hi[0], cur.lo[0])
