"""Wide k-mer codes (k in (31, 63]): 4x uint32 words + fingerprint keys.

Reference analogue: the large-k `kmer_type` = 128-bit int compile switch
(ref:src/Kmer.h [C:high], SURVEY.md §2.1). Device re-design: codes are
tuples of 4 uint32 words (most-significant first) handled by the same
elementwise 32-bit integer ops as the 2-word path; the *table/Bloom key*
for a wide k-mer is a 62-bit hash fingerprint of its canonical code
(collision odds ~n^2/2^62 — far below sequencing noise), so every
downstream structure
(cascade, junction/sink/pair tables, routing) is width-agnostic. The
true code words ride along as table VALUES where walks need to seed from
them (SURVEY.md §7.3 M3 "128-bit k-mers on int32-native hardware").
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from faucet_tpu.core.hashing import fmix32, hash_pair

U32 = jnp.uint32
NW = 4  # words per wide code


def wzero(shape):
    z = jnp.zeros(shape, U32)
    return (z, z, z, z)


def wshl2(w):
    a, b, c, d = w
    s = np.uint32(2)
    t = np.uint32(30)
    return ((a << s) | (b >> t), (b << s) | (c >> t),
            (c << s) | (d >> t), d << s)


def wshr2(w):
    a, b, c, d = w
    s = np.uint32(2)
    t = np.uint32(30)
    return (a >> s, (b >> s) | (a << t), (c >> s) | (b << t),
            (d >> s) | (c << t))


def wor_low(w, v):
    a, b, c, d = w
    return (a, b, c, d | v.astype(U32))


def wor_at(w, v, bitpos: int):
    """OR 2-bit v at static bit offset (0 = LSB of word 3)."""
    v = v.astype(U32)
    word = 3 - bitpos // 32
    out = list(w)
    out[word] = out[word] | (v << np.uint32(bitpos % 32))
    return tuple(out)


def wmask(w, nbits: int):
    """Keep low nbits (static)."""
    out = list(w)
    for i in range(NW):
        lo_bit = 32 * (NW - 1 - i)   # bit offset of word i's LSB
        if nbits <= lo_bit:
            out[i] = jnp.zeros_like(out[i])
        elif nbits < lo_bit + 32:
            out[i] = out[i] & np.uint32((1 << (nbits - lo_bit)) - 1)
    return tuple(out)


def wle(x, y):
    """x <= y lexicographic over words."""
    res = x[NW - 1] <= y[NW - 1]
    for i in range(NW - 2, -1, -1):
        res = (x[i] < y[i]) | ((x[i] == y[i]) & res)
    return res


def weq(x, y):
    r = x[0] == y[0]
    for i in range(1, NW):
        r = r & (x[i] == y[i])
    return r


def wselect(pred, x, y):
    return tuple(jnp.where(pred, a, b) for a, b in zip(x, y))


def fingerprint(w):
    """4-word canonical code -> (hi < 2^30, lo) table/Bloom key."""
    h1a, h2a = hash_pair(w[0], w[1])
    h1b, h2b = hash_pair(w[2], w[3])
    hi = fmix32(h1a + np.uint32(3) * h1b) & np.uint32(0x3FFFFFFF)
    lo = fmix32(h2a ^ (h2b * np.uint32(5)))
    return hi, lo


# ---- rolling kmerization (wide) ----------------------------------------


class WideView(NamedTuple):
    fwd: Tuple[jnp.ndarray, ...]    # 4 x [B, P]
    rc: Tuple[jnp.ndarray, ...]
    canon: Tuple[jnp.ndarray, ...]
    canon_is_fwd: jnp.ndarray
    valid: jnp.ndarray
    key_hi: jnp.ndarray             # fingerprint of canon
    key_lo: jnp.ndarray


def kmerize_wide(bases, lens, k: int) -> WideView:
    """All wide k-windows, fully vectorized (no sequential scan): base
    at window offset j lands at bit 2(k-1-j) of fwd and bit 2j of rc —
    direct bit-sums over k strided [B, P] slices, bit-identical to the
    rolling wshl2/wshr2 recurrence (tests/golden/test_wide_k.py) but free
    of lax.scan's one dependent step per position."""
    B, L = bases.shape
    P = L - k + 1

    ok = bases < 4
    bb = jnp.where(ok, bases, 0).astype(U32)
    fwd = list(wzero((B, P)))
    rc = list(wzero((B, P)))
    for j in range(k):
        w = jax.lax.slice_in_dim(bb, j, j + P, axis=1)
        bf = 2 * (k - 1 - j)           # fwd bit offset (0 = LSB word 3)
        fwd[3 - bf // 32] = fwd[3 - bf // 32] | (w << (bf % 32))
        br = 2 * j
        wc = np.uint32(3) - w
        rc[3 - br // 32] = rc[3 - br // 32] | (wc << (br % 32))
    fwd, rc = tuple(fwd), tuple(rc)

    cbad = jnp.cumsum((~ok).astype(jnp.int32), axis=1)
    bad_in_win = (jax.lax.slice_in_dim(cbad, k - 1, L, axis=1)
                  - jnp.pad(cbad, ((0, 0), (1, 0)))[:, :P])
    ends = jnp.arange(k - 1, L, dtype=jnp.int32)[None, :]
    valid = (bad_in_win == 0) & (ends < lens[:, None])
    cisf = wle(fwd, rc)
    canon = wselect(cisf, fwd, rc)
    khi, klo = fingerprint(canon)
    return WideView(fwd=fwd, rc=rc, canon=canon, canon_is_fwd=cisf,
                    valid=valid, key_hi=khi, key_lo=klo)


def right_ext_wide(fwd, rc, b, k: int):
    top = 2 * (k - 1)
    b = jnp.asarray(b).astype(U32)
    nf = wmask(wor_low(wshl2(fwd), b), 2 * k)
    nr = wor_at(wshr2(rc), np.uint32(3) - b, top)
    return nf, nr


def left_ext_wide(fwd, rc, c, k: int):
    top = 2 * (k - 1)
    c = jnp.asarray(c).astype(U32)
    nf = wor_at(wshr2(fwd), c, top)
    nr = wmask(wor_low(wshl2(rc), np.uint32(3) - c), 2 * k)
    return nf, nr


def canon_of_wide(fwd, rc):
    cisf = wle(fwd, rc)
    return wselect(cisf, fwd, rc), cisf


def slot_ext_keys_wide(canon, other, k: int):
    """Fingerprints of the 8 slot-extensions (canonical-frame)."""
    his, los = [], []
    for b in range(4):
        nf, nr = right_ext_wide(canon, other, np.uint32(b), k)
        c, _ = canon_of_wide(nf, nr)
        hi, lo = fingerprint(c)
        his.append(hi)
        los.append(lo)
    for c_ in range(4):
        nf, nr = left_ext_wide(canon, other, np.uint32(c_), k)
        c, _ = canon_of_wide(nf, nr)
        hi, lo = fingerprint(c)
        his.append(hi)
        los.append(lo)
    return jnp.stack(his, axis=-1), jnp.stack(los, axis=-1)


def wtop_base(fwd, k: int):
    bitpos = 2 * (k - 1)
    word = 3 - bitpos // 32
    return ((fwd[word] >> np.uint32(bitpos % 32)) & np.uint32(3)).astype(
        jnp.int32)


# ---- host helpers ------------------------------------------------------


def revcomp_words_np(words: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of 4-word (128-bit container) codes
    (host numpy). words: uint32[n, 4], big-endian word order, value
    right-aligned to 2k bits. Replaces the per-row string decode/encode
    round trip in the graph phase (VERDICT r1 #4)."""
    w = np.asarray(words, np.uint64)
    hi = (w[:, 0] << np.uint64(32)) | w[:, 1]
    lo = (w[:, 2] << np.uint64(32)) | w[:, 3]
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)

    def rev64(v):
        v = ((v >> np.uint64(2)) & m2) | ((v & m2) << np.uint64(2))
        v = ((v >> np.uint64(4)) & m4) | ((v & m4) << np.uint64(4))
        return v.byteswap()

    rhi, rlo = rev64(~lo), rev64(~hi)  # full-128 2-bit-group reversal
    s = 128 - 2 * k
    if 0 < s < 64:
        s = np.uint64(s)
        rlo = (rlo >> s) | (rhi << (np.uint64(64) - s))
        rhi = rhi >> s
    elif s >= 64:
        rlo = rhi >> np.uint64(s - 64)
        rhi = np.zeros_like(rhi)
    mask2k = (np.uint64(1) << np.uint64(max(2 * k - 64, 0))) - np.uint64(1)
    rhi = rhi & mask2k
    out = np.empty_like(np.asarray(words, np.uint32))
    out[:, 0] = (rhi >> np.uint64(32)).astype(np.uint32)
    out[:, 1] = (rhi & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 2] = (rlo >> np.uint64(32)).astype(np.uint32)
    out[:, 3] = (rlo & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def fingerprint_keys_np(words: np.ndarray) -> np.ndarray:
    """uint32[n, 4] canonical codes -> uint64 fingerprint table keys
    (bit-identical to the device fingerprint), vectorized."""
    w = np.asarray(words, np.uint32)
    hi, lo = fingerprint_np((w[:, 0], w[:, 1], w[:, 2], w[:, 3]))
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64)


def encode_windows_wide_np(seq: str, k: int) -> np.ndarray:
    """Fingerprint keys of every canonical k-window of a host string,
    vectorized (the wide analog of kmer.encode_windows_np; visited-set
    keys share the junction/sink tables' key space)."""
    from faucet_tpu.core.kmer import encode_seq

    t = encode_seq(seq).astype(np.uint64)
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros((0,), np.uint64)
    hi = np.zeros((n,), np.uint64)
    lo = np.zeros((n,), np.uint64)
    for j in range(k):
        hi = ((hi << np.uint64(2)) | (lo >> np.uint64(62)))
        lo = (lo << np.uint64(2)) | t[j : j + n]
    hi = hi & ((np.uint64(1) << np.uint64(max(2 * k - 64, 0)))
               - np.uint64(1))
    fwd = np.stack([(hi >> np.uint64(32)).astype(np.uint32),
                    (hi & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                    (lo >> np.uint64(32)).astype(np.uint32),
                    (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                   axis=1)
    rc = revcomp_words_np(fwd, k)
    # lexicographic min over the 128-bit values
    fw = fwd.astype(np.uint64)
    rw = rc.astype(np.uint64)
    lt = np.zeros((n,), bool)
    gt = np.zeros((n,), bool)
    for c in range(4):
        lt = lt | (~gt & (fw[:, c] < rw[:, c]))
        gt = gt | (~lt & (fw[:, c] > rw[:, c]))
    canon = np.where(lt[:, None] | ~gt[:, None], fwd, rc)
    return fingerprint_keys_np(canon)


def fingerprint_np(words):
    """Host numpy/int mirror of fingerprint (bit-identical)."""
    from faucet_tpu.core.hashing import fmix32_np, hash_pair_np

    h1a, h2a = hash_pair_np(words[0], words[1])
    h1b, h2b = hash_pair_np(words[2], words[3])
    with np.errstate(over="ignore"):
        hi = fmix32_np(h1a + np.uint32(3) * h1b) & np.uint32(0x3FFFFFFF)
        lo = fmix32_np(h2a ^ (h2b * np.uint32(5)))
    return hi, lo


def encode_kmer_wide(s: str):
    v = 0
    from faucet_tpu.core.kmer import encode_seq

    for c in encode_seq(s):
        assert c < 4
        v = (v << 2) | int(c)
    return tuple((v >> (32 * (NW - 1 - i))) & 0xFFFFFFFF
                 for i in range(NW))


def decode_kmer_wide(words, k: int) -> str:
    v = 0
    for w in words:
        v = (v << 32) | int(w)
    return "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))
