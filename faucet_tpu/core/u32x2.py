"""64-bit integer arithmetic as (hi, lo) uint32 pairs.

Rather than enabling global x64 (which drags float64 defaults into the
compute path), k-mer codes up to 62 bits travel the pipeline as explicit
(hi, lo) uint32 pairs. All ops are elementwise and shape-polymorphic, and
lower to plain 32-bit integer ops under jit.

Reference analogue: Faucet's ``kmer_type`` compile-time switch between 64-
and 128-bit ints (SURVEY.md §2.1 "K-mer codec", ref:src/Kmer.h [C:high]).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32
_ZERO = np.uint32(0)


def u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=U32)


def shl2(hi, lo):
    """(hi, lo) << 2, high bits fall off."""
    return (hi << np.uint32(2)) | (lo >> np.uint32(30)), lo << np.uint32(2)


def shr2(hi, lo):
    """(hi, lo) >> 2 logical."""
    return hi >> np.uint32(2), (lo >> np.uint32(2)) | (hi << np.uint32(30))


def or_base_low(hi, lo, b):
    """OR a 2-bit value into the lowest bits."""
    return hi, lo | b.astype(U32)


def or_base_at(hi, lo, b, bitpos: int):
    """OR a 2-bit value at static bit offset `bitpos` (0 = LSB of lo)."""
    b = b.astype(U32)
    if bitpos >= 32:
        return hi | (b << np.uint32(bitpos - 32)), lo
    return hi, lo | (b << np.uint32(bitpos))


def mask_bits(hi, lo, nbits: int):
    """Keep only the low `nbits` bits of the pair (static nbits)."""
    if nbits >= 64:
        return hi, lo
    if nbits >= 32:
        m = np.uint32((1 << (nbits - 32)) - 1)
        return hi & m, lo
    m = np.uint32((1 << nbits) - 1)
    return jnp.zeros_like(hi), lo & m


def eq(a_hi, a_lo, b_hi, b_lo):
    return (a_hi == b_hi) & (a_lo == b_lo)


def lt(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def le(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def select(pred, a_hi, a_lo, b_hi, b_lo):
    """Elementwise pred ? a : b on pairs."""
    return jnp.where(pred, a_hi, b_hi), jnp.where(pred, a_lo, b_lo)


def min_pair(a_hi, a_lo, b_hi, b_lo):
    take_a = lt(a_hi, a_lo, b_hi, b_lo)
    return select(take_a, a_hi, a_lo, b_hi, b_lo)


# ---- host-side helpers (numpy / python int) ----------------------------

def to_int(hi, lo):
    """Pair -> python-int array (host)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64)


def from_int(v):
    """Python-int / uint64 array -> (hi, lo) uint32 numpy pair (host)."""
    v = np.asarray(v, dtype=np.uint64)
    return (v >> np.uint64(32)).astype(np.uint32), (
        v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
