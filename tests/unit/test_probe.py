"""bloom_contains (one 64 B row gather per key) against a NumPy bit
test of the same blocked layout."""
import numpy as np
import jax.numpy as jnp
import pytest

from faucet_tpu.core import bloom as BL


def _np_contains(words, khi, klo, mask, n_hash, log2_bits):
    block, bits = BL._block_and_bits(jnp.asarray(khi), jnp.asarray(klo),
                                     n_hash, log2_bits)
    w = np.asarray(block)[:, None].astype(np.int64) * BL.BLOCK_WORDS \
        + (np.asarray(bits) >> 5)
    hit = (np.asarray(words)[w] >> (np.asarray(bits) & 31)) & 1
    return hit.all(axis=1) & mask


def _keys(rng, n):
    return (rng.integers(0, 1 << 30, size=n).astype(np.uint32),
            rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
            .astype(np.uint32))


@pytest.mark.parametrize("log2_bits,n_keys,n_hash",
                         [(16, 300, 3), (19, 5000, 7), (22, 3000, 3)])
def test_contains_matches_bit_test(rng, log2_bits, n_keys, n_hash):
    b = BL.make_bloom(log2_bits)
    ihi, ilo = _keys(rng, n_keys)
    b = BL.bloom_insert(b, jnp.asarray(ihi), jnp.asarray(ilo),
                        jnp.ones(n_keys, bool), n_hash, log2_bits)
    # queries: half inserted keys, half fresh, some masked off
    fhi, flo = _keys(rng, n_keys // 2)
    qhi = np.concatenate([ihi[: n_keys // 2], fhi])
    qlo = np.concatenate([ilo[: n_keys // 2], flo])
    qmask = rng.random(len(qhi)) < 0.8
    got = np.asarray(BL.bloom_contains(b, jnp.asarray(qhi), jnp.asarray(qlo),
                                       jnp.asarray(qmask), n_hash,
                                       log2_bits))
    np.testing.assert_array_equal(
        got, _np_contains(b.words, qhi, qlo, qmask, n_hash, log2_bits))
    # no false negatives among the inserted, unmasked keys
    assert got[: n_keys // 2][qmask[: n_keys // 2]].all()


def test_contains_odd_sizes_and_shapes(rng):
    """Key counts that are no power of two, and a 2-D query grid."""
    ihi, ilo = _keys(rng, 500)
    b = BL.bloom_insert(BL.make_bloom(16), jnp.asarray(ihi),
                        jnp.asarray(ilo), jnp.ones(500, bool), 3, 16)
    for n in (1, 3, 7, 130, 2049):
        qhi = np.concatenate([ihi, _keys(rng, n)[0]])[-n:]
        qlo = np.concatenate([ilo, _keys(rng, n)[1]])[-n:]
        got = BL.bloom_contains(b, jnp.asarray(qhi), jnp.asarray(qlo),
                                jnp.ones(n, bool), 3, 16)
        np.testing.assert_array_equal(
            np.asarray(got),
            _np_contains(b.words, qhi, qlo, np.ones(n, bool), 3, 16))
    grid = BL.bloom_contains(b, jnp.asarray(ihi[:400].reshape(20, 20)),
                             jnp.asarray(ilo[:400].reshape(20, 20)),
                             jnp.ones((20, 20), bool), 3, 16)
    assert grid.shape == (20, 20) and np.asarray(grid).all()
