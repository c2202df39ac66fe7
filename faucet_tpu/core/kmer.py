"""K-mer codec: 2-bit packing, rolling codes, canonical form, extensions.

Reference analogue: ref:src/Kmer.{h,cpp} + ref:src/ReadKmer.{h,cpp}
(SURVEY.md §2.1, [C:high]) — `codeSeed`, `revcomp`, canonical helpers and
the double-strand read walker. The device re-design replaces the per-read
sequential iterator with one batched `lax.scan` over the position axis that
emits forward and reverse-complement codes for *every* window of *every*
read in a [B, P] tensor at once (SURVEY.md §7.1.1: dataflow, not
pointer-chasing).

Conventions (fixed here, per SURVEY.md §A.1):
- alphabet code A=0, C=1, G=2, T=3; complement(b) = 3 - b; code 4 = N/pad.
- forward code of window x[0..k-1] packs x[0] in the most-significant 2 bits.
- canonical(x) = min(code(x), code(revcomp(x))); k odd so never equal.
- node slots: 0..3 = right extension of the *canonical* orientation by base
  slot; 4..7 = left extension by base slot-4. (The reference keeps 5
  read-orientation slots, ref:src/Junction.h [C:med]; 8 canonical slots are
  symmetric and vectorize as one [.., 8] probe — an intentional divergence.)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from faucet_tpu.core import u32x2 as u2
from faucet_tpu.core.hashing import hash_pair

U32 = jnp.uint32

# ---- host-side string <-> code helpers ---------------------------------

_BASE_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _BASE_TO_CODE[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    _BASE_TO_CODE[_b] = _c
_CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_seq(seq: str) -> np.ndarray:
    """DNA string -> uint8 codes (N and anything non-ACGT -> 4)."""
    return _BASE_TO_CODE[np.frombuffer(seq.encode(), dtype=np.uint8)]


def decode_seq(codes) -> str:
    return _CODE_TO_BASE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


# Full 256-entry complement table: ACGT/acgt -> uppercase complement,
# every other byte -> 'N' (ADVICE r4: preserves the old encode/decode
# path's normalization — uppercasing and non-ACGT -> N — which the
# narrow 8-char maketrans silently dropped).
_RC_TABLE = {i: "N" for i in range(256)}
_RC_TABLE.update({ord(a): b for a, b in
                  zip("ACGTacgt", "TGCATGCA")})


def revcomp_seq(seq: str) -> str:
    # str.translate is ~10x faster than the numpy encode/decode round
    # trip for k-mer-sized strings (round-4 profile: 43M calls = 390 s
    # of a 2 Mbp quality run)
    return seq.translate(_RC_TABLE)[::-1]


def pack_reads(seqs, max_len: int):
    """List of read strings -> (bases uint8[B, max_len], lens int32[B]).

    Reads longer than max_len are truncated (reference bounds reads by
    -max_read_length the same way, SURVEY.md §5).
    """
    B = len(seqs)
    bases = np.full((B, max_len), 4, dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, s in enumerate(seqs):
        c = encode_seq(s)[:max_len]
        bases[i, : len(c)] = c
        lens[i] = len(c)
    return bases, lens


def encode_kmer(s: str):
    """k-mer string -> (hi, lo) python ints (host)."""
    v = 0
    for c in encode_seq(s):
        assert c < 4, "k-mer must be ACGT only"
        v = (v << 2) | int(c)
    return (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF


def revcomp_code_np(v: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of packed 2-bit codes (host numpy).

    v: uint64 array of 2k-bit codes. Complement = bitwise NOT per 2-bit
    base (A<->T, C<->G under our encoding), then reverse base order via
    the classic 2-bit/4-bit swap + byteswap, then right-align.
    """
    v = (~np.asarray(v, dtype=np.uint64))
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    v = ((v >> np.uint64(2)) & m2) | ((v & m2) << np.uint64(2))
    v = ((v >> np.uint64(4)) & m4) | ((v & m4) << np.uint64(4))
    v = v.byteswap()
    return v >> np.uint64(64 - 2 * k)


def neighbor_keys_np(keys: np.ndarray, k: int) -> np.ndarray:
    """Canonical codes of the 8 single-base neighbors of each canonical
    code: [n] uint64 -> [n, 8] (4 right extensions, 4 left). Host numpy
    twin of slot_ext_pairs, used by the graph build to pre-filter pass-2
    sink seeds that sit one base off already-walked territory."""
    keys = np.asarray(keys, np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    top = np.uint64(2 * (k - 1))
    out = np.empty((len(keys), 8), np.uint64)
    for b in range(4):
        r = ((keys << np.uint64(2)) | np.uint64(b)) & mask
        out[:, b] = np.minimum(r, revcomp_code_np(r, k))
        lft = (keys >> np.uint64(2)) | (np.uint64(b) << top)
        out[:, 4 + b] = np.minimum(lft, revcomp_code_np(lft, k))
    return out


_POW4_CACHE = {}


def _POW4(k: int) -> np.ndarray:
    """[k] uint64 place values 4**(k-1-j) for window packing."""
    p = _POW4_CACHE.get(k)
    if p is None:
        p = np.uint64(1) << (np.uint64(2)
                             * np.arange(k - 1, -1, -1, dtype=np.uint64))
        _POW4_CACHE[k] = p
    return p


def encode_windows_np(seq: str, k: int) -> np.ndarray:
    """Canonical codes of every k-window of a host string, vectorized
    (uint64[len(seq)-k+1]). Replaces per-window Python encode/canon in
    the graph phase (VERDICT r1 #4). Assumes ACGT-only input."""
    t = _BASE_TO_CODE[np.frombuffer(seq.encode(), np.uint8)]
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros((0,), np.uint64)
    if n < 4 * k:
        # short strings (error-island contigs, trims): the k-step loop
        # pays ~2k numpy dispatches; a [n, k] window matrix needs 3
        # (round-4 profile: 13 s of a 98 s graph build was this loop
        # over ~60 bp junk contigs)
        from numpy.lib.stride_tricks import sliding_window_view

        # OR-accumulate (not multiply-add): bit-identical to the long
        # path's shift-OR even for out-of-contract code-4 (N) bytes
        # (ADVICE r4: (v<<2)|4 != v*4+4 when bit 0 of v is set)
        win = sliding_window_view(t, k).astype(np.uint64)
        sh = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
        v = np.bitwise_or.reduce(win << sh[None, :], axis=1)
    else:
        v = np.zeros((n,), np.uint64)
        for j in range(k):
            v = (v << np.uint64(2)) | t[j : j + n].astype(np.uint64)
    return np.minimum(v, revcomp_code_np(v, k))


def decode_kmers_np(v: np.ndarray, k: int):
    """uint64 packed codes -> list of k-mer strings, vectorized."""
    v = np.asarray(v, np.uint64)
    n = v.shape[0]
    if n == 0:
        return []
    shifts = (np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64))
    b = ((v[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    flat = _CODE_TO_BASE[b].tobytes().decode()
    return [flat[i * k : (i + 1) * k] for i in range(n)]


def decode_kmer(hi: int, lo: int, k: int) -> str:
    v = (int(hi) << 32) | int(lo)
    out = []
    for i in range(k):
        out.append("ACGT"[(v >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


# ---- batched rolling kmerization ---------------------------------------


class KmerView(NamedTuple):
    """Per-position window codes for a read batch; all arrays [B, P]."""

    fwd_hi: jnp.ndarray   # forward-orientation code of window
    fwd_lo: jnp.ndarray
    rc_hi: jnp.ndarray    # reverse-complement code of window
    rc_lo: jnp.ndarray
    canon_hi: jnp.ndarray
    canon_lo: jnp.ndarray
    canon_is_fwd: jnp.ndarray  # bool: canonical == forward orientation
    valid: jnp.ndarray         # bool: window inside read and ACGT-only


def kmerize(bases: jnp.ndarray, lens: jnp.ndarray, k: int) -> KmerView:
    """All k-windows of a read batch, fully vectorized.

    bases: uint8[B, L] (codes 0..3, 4=N/pad); lens: int32[B].
    Returns KmerView with P = L - k + 1 positions (window start index).

    Window codes are direct bit-sums over k strided [B, P] slices —
    fwd = sum_j bb[p+j] << 2(k-1-j), rc = sum_j (3-bb[p+j]) << 2j —
    bit-identical to a rolling shl2/shr2 recurrence but with NO
    sequential dependency: a lax.scan over the L axis is L dependent
    steps, while these k unrolled elementwise passes fuse into one
    kernel. Shifts never
    straddle the 32-bit word boundary (all shift amounts are even), so
    each base targets exactly one of the hi/lo words.
    """
    B, L = bases.shape
    P = L - k + 1
    assert P >= 1

    ok = bases < 4
    bb = jnp.where(ok, bases, 0).astype(U32)
    z = jnp.zeros((B, P), dtype=U32)
    fhi, flo, rhi, rlo = z, z, z, z
    for j in range(k):
        w = jax.lax.slice_in_dim(bb, j, j + P, axis=1)
        sf = 2 * (k - 1 - j)
        if sf >= 32:
            fhi = fhi | (w << (sf - 32))
        else:
            flo = flo | (w << sf)
        wc = np.uint32(3) - w
        sr = 2 * j
        if sr >= 32:
            rhi = rhi | (wc << (sr - 32))
        else:
            rlo = rlo | (wc << sr)

    # validity: every base of the window ok AND window end inside read.
    cbad = jnp.cumsum((~ok).astype(jnp.int32), axis=1)  # inclusive
    bad_in_win = (jax.lax.slice_in_dim(cbad, k - 1, L, axis=1)
                  - jnp.pad(cbad, ((0, 0), (1, 0)))[:, :P])
    ends = jnp.arange(k - 1, L, dtype=jnp.int32)[None, :]  # [1, P]
    valid = (bad_in_win == 0) & (ends < lens[:, None])

    canon_is_fwd = u2.le(fhi, flo, rhi, rlo)
    chi, clo = u2.select(canon_is_fwd, fhi, flo, rhi, rlo)
    return KmerView(fhi, flo, rhi, rlo, chi, clo, canon_is_fwd, valid)


# ---- extensions --------------------------------------------------------


def right_ext(fhi, flo, rhi, rlo, b, k: int):
    """Append base b on the right of the (fwd, rc) frame; returns the new
    (fwd, rc) pair codes. b may be a traced array broadcastable to fhi."""
    top = 2 * (k - 1)
    b = jnp.asarray(b).astype(U32)
    efh, efl = u2.shl2(fhi, flo)
    efh, efl = u2.or_base_low(efh, efl, b)
    efh, efl = u2.mask_bits(efh, efl, 2 * k)
    erh, erl = u2.shr2(rhi, rlo)
    erh, erl = u2.or_base_at(erh, erl, np.uint32(3) - b, top)
    return efh, efl, erh, erl


def left_ext(fhi, flo, rhi, rlo, c, k: int):
    """Prepend base c on the left of the (fwd, rc) frame."""
    top = 2 * (k - 1)
    c = jnp.asarray(c).astype(U32)
    efh, efl = u2.shr2(fhi, flo)
    efh, efl = u2.or_base_at(efh, efl, c, top)
    erh, erl = u2.shl2(rhi, rlo)
    erh, erl = u2.or_base_low(erh, erl, np.uint32(3) - c)
    erh, erl = u2.mask_bits(erh, erl, 2 * k)
    return efh, efl, erh, erl


def canon_of(fhi, flo, rhi, rlo):
    is_fwd = u2.le(fhi, flo, rhi, rlo)
    chi, clo = u2.select(is_fwd, fhi, flo, rhi, rlo)
    return chi, clo, is_fwd


def slot_ext_pairs(canon_hi, canon_lo, other_hi, other_lo, k: int):
    """Canonical codes of the 8 slot-extension k-mers of each node.

    canon = canonical code, other = code of its reverse complement.
    Returns (ehi, elo) each [..., 8]: slots 0..3 right-ext by base, 4..7
    left-ext by base-4. This is the dense 8-way junction probe of
    SURVEY.md §3.2 re-cast as pure elementwise tensor ops; membership
    backends hash the pairs themselves (Bloom) or look them up (exact).
    """
    ehis, elos = [], []
    for b in range(4):
        fh, fl, rh, rl = right_ext(canon_hi, canon_lo, other_hi, other_lo,
                                   np.uint32(b), k)
        chi, clo, _ = canon_of(fh, fl, rh, rl)
        ehis.append(chi)
        elos.append(clo)
    for c in range(4):
        fh, fl, rh, rl = left_ext(canon_hi, canon_lo, other_hi, other_lo,
                                  np.uint32(c), k)
        chi, clo, _ = canon_of(fh, fl, rh, rl)
        ehis.append(chi)
        elos.append(clo)
    return jnp.stack(ehis, axis=-1), jnp.stack(elos, axis=-1)
