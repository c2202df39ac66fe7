"""Bit-identity of the vectorized kmerize / _row_runs rewrites.

Round-2 perf work replaced the lax.scan-over-positions formulations
(ref-style sequential recurrences, one dependent step per position)
with cumulative-op formulations. These tests pin the vectorized
code lane-for-lane against the original sequential recurrences, which
are re-stated here in plain numpy as the spec.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from faucet_tpu.core import kmer as KM
from faucet_tpu.core import scan as SC


def _rolling_kmerize_np(bases, lens, k):
    """The round-1 sequential recurrence (kmer.py history), in numpy."""
    B, L = bases.shape
    P = L - k + 1
    fwd = np.zeros((B, L), np.uint64)
    rc = np.zeros((B, L), np.uint64)
    nok = np.zeros((B, L), np.int64)
    f = np.zeros(B, np.uint64)
    r = np.zeros(B, np.uint64)
    n = np.zeros(B, np.int64)
    mask = np.uint64((1 << (2 * k)) - 1)
    for t in range(L):
        b = bases[:, t].astype(np.int64)
        ok = b < 4
        bb = np.where(ok, b, 0).astype(np.uint64)
        f = ((f << np.uint64(2)) | bb) & mask
        r = (r >> np.uint64(2)) | ((np.uint64(3) - bb)
                                   << np.uint64(2 * (k - 1)))
        n = np.where(ok, n + 1, 0)
        fwd[:, t], rc[:, t], nok[:, t] = f, r, n
    fwd, rc, nok = fwd[:, k - 1:], rc[:, k - 1:], nok[:, k - 1:]
    ends = np.arange(k - 1, L)[None, :]
    valid = (nok >= k) & (ends < lens[:, None])
    canon = np.minimum(fwd, rc)
    return fwd, rc, canon, valid


@pytest.mark.parametrize("k", [5, 17, 31])
def test_kmerize_matches_rolling(k):
    rng = np.random.default_rng(3)
    B, L = 64, 71
    bases = rng.integers(0, 5, (B, L)).astype(np.uint8)  # incl. N=4
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    v = KM.kmerize(jnp.asarray(bases), jnp.asarray(lens), k)
    pair = lambda hi, lo: (np.asarray(hi).astype(np.uint64)
                           << np.uint64(32)) | np.asarray(lo)
    fwd, rc, canon, valid = _rolling_kmerize_np(bases, lens, k)
    np.testing.assert_array_equal(pair(v.fwd_hi, v.fwd_lo), fwd)
    np.testing.assert_array_equal(pair(v.rc_hi, v.rc_lo), rc)
    np.testing.assert_array_equal(pair(v.canon_hi, v.canon_lo), canon)
    np.testing.assert_array_equal(np.asarray(v.valid), valid)


def _row_runs_np(solid, is_junc):
    """The round-1 two-scan recurrence (scan.py history), in numpy."""
    B, P = solid.shape
    rs = np.zeros((B, P), np.int32)
    pj = np.zeros((B, P), np.int32)
    cnt = np.zeros((B, P), np.int32)
    re = np.zeros((B, P), np.int32)
    nj = np.zeros((B, P), np.int32)
    tot = np.zeros((B, P), np.int32)
    prev = np.pad(solid[:, :-1], ((0, 0), (1, 0)))
    nxt = np.pad(solid[:, 1:], ((0, 0), (0, 1)))
    start_m = solid & ~prev
    end_m = solid & ~nxt
    for i in range(B):
        r, p_, c = 0, -1, 0
        for p in range(P):
            if start_m[i, p]:
                r, p_, c = p, -1, 0
            rs[i, p], pj[i, p] = r, p_
            if is_junc[i, p]:
                p_ = p
            c += int(is_junc[i, p])
            cnt[i, p] = c
        e, n_, t = 0, -1, 0
        for p in range(P - 1, -1, -1):
            if end_m[i, p]:
                e, n_, t = p, -1, cnt[i, p]
            re[i, p], nj[i, p], tot[i, p] = e, n_, t
            if is_junc[i, p]:
                n_ = p
    return rs, re, pj, nj, tot, start_m, end_m


@pytest.mark.parametrize("subset", [True, False])
def test_row_runs_matches_sequential(subset):
    rng = np.random.default_rng(11)
    B, P = 48, 37
    solid = rng.random((B, P)) < 0.7
    is_junc = rng.random((B, P)) < 0.25
    if subset:
        is_junc &= solid  # production invariant
    got = SC._row_runs(jnp.asarray(solid), jnp.asarray(is_junc))
    want = _row_runs_np(solid, is_junc)
    names = ["rs", "re", "pj", "nj", "tot", "start_m", "end_m"]
    for nm, g, w in zip(names, got, want):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=nm)
