"""32-bit hashing for k-mer codes.

The reference uses Minia-lineage multiplicative hashing over the packed
k-mer (SURVEY.md §2.1 "Bloom filter", ref:src/Bloom.cpp [C:high]); hash
functions here differ by design — contig-level equivalence, not bit-level
Bloom equality, is the parity target (SURVEY.md §7.1.6).

Scheme: murmur3's 32-bit finalizer (`fmix32`) chained over the two words of
a k-mer code yields two independent 32-bit hashes (h1, h2). Bloom probe i
uses Kirsch–Mitzenmacher double hashing h1 + i*h2 (h2 forced odd), which is
provably fp-rate-preserving and needs no 64-bit multiplies.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_SEED1 = np.uint32(0x9E3779B9)
_SEED2 = np.uint32(0x85EBCA77)


def fmix32(x):
    """murmur3 32-bit finalizer; good avalanche, wraps on uint32."""
    x = x.astype(U32)
    x = x ^ (x >> np.uint32(16))
    x = x * _C1
    x = x ^ (x >> np.uint32(13))
    x = x * _C2
    x = x ^ (x >> np.uint32(16))
    return x


def hash_pair(hi, lo):
    """(hi, lo) k-mer code -> (h1, h2) independent 32-bit hashes.

    h2 is forced odd so double-hashed probe strides are units mod 2^b.
    """
    h1 = fmix32(lo.astype(U32) ^ fmix32(hi.astype(U32) ^ _SEED1))
    h2 = fmix32(hi.astype(U32) ^ fmix32(lo.astype(U32) ^ _SEED2)) | np.uint32(1)
    return h1, h2


def bloom_positions(h1, h2, n_hash: int, log2_bits: int):
    """Bit positions for the n_hash Bloom probes of each item.

    Returns uint32[..., n_hash] in [0, 2**log2_bits).
    """
    i = jnp.arange(n_hash, dtype=U32)
    pos = h1[..., None] + i * h2[..., None]
    return pos & np.uint32((1 << log2_bits) - 1)


def pair_key(ahi, alo, bhi, blo):
    """Order-independent 64-bit key for a junction pair (jnp arrays).

    The pair store (ref:src/JuncPairs.* [C:med], SURVEY.md §2.1) keys on
    (kmer, kmer); here the unordered pair hash-combines into one (hi, lo)
    key for the generic device table. Collisions are ~2^-64-scale noise on
    disentangle evidence counts.
    """
    swap = (bhi < ahi) | ((bhi == ahi) & (blo < alo))
    xhi = jnp.where(swap, bhi, ahi)
    xlo = jnp.where(swap, blo, alo)
    yhi = jnp.where(swap, ahi, bhi)
    ylo = jnp.where(swap, alo, blo)
    h1x, h2x = hash_pair(xhi, xlo)
    h1y, h2y = hash_pair(yhi, ylo)
    khi = fmix32(h1x + np.uint32(3) * h1y)
    klo = fmix32(h2x ^ (h2y * np.uint32(5)))
    # keep khi out of the table's EMPTY sentinel range
    return khi & np.uint32(0x3FFFFFFF), klo


def fmix32_np(x: np.ndarray) -> np.ndarray:
    """Host numpy mirror of fmix32 (bit-identical)."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def hash_pair_np(hi, lo):
    """Host numpy mirror of hash_pair (bit-identical)."""
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    h1 = fmix32_np(lo ^ fmix32_np(hi ^ np.uint32(0x9E3779B9)))
    h2 = fmix32_np(hi ^ fmix32_np(lo ^ np.uint32(0x85EBCA77))) | np.uint32(1)
    return h1, h2


def pair_key_np(ahi, alo, bhi, blo):
    """Host numpy mirror of pair_key (bit-identical)."""
    ahi, alo = np.asarray(ahi, np.uint32), np.asarray(alo, np.uint32)
    bhi, blo = np.asarray(bhi, np.uint32), np.asarray(blo, np.uint32)
    swap = (bhi < ahi) | ((bhi == ahi) & (blo < alo))
    xhi, xlo = np.where(swap, bhi, ahi), np.where(swap, blo, alo)
    yhi, ylo = np.where(swap, ahi, bhi), np.where(swap, alo, blo)
    h1x, h2x = hash_pair_np(xhi, xlo)
    h1y, h2y = hash_pair_np(yhi, ylo)
    with np.errstate(over="ignore"):
        khi = fmix32_np(h1x + np.uint32(3) * h1y)
        klo = fmix32_np(h2x ^ (h2y * np.uint32(5)))
    return khi & np.uint32(0x3FFFFFFF), klo


def shard_of(h1, log2_shards: int):
    """Owner shard of a k-mer = top bits of h1 (independent of the low
    bits used for Bloom/table indexing)."""
    if log2_shards == 0:
        return jnp.zeros_like(h1, dtype=U32)
    return h1 >> np.uint32(32 - log2_shards)
