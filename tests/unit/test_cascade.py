"""The sort+count cascade (core/bloom.cascade_insert_nbs) against a
sequential NumPy reference.

The reference walks the batch key by key in lane order: "if A has k: add
k to B, else add k to A". Membership is the filters as they stood before
the batch plus the keys this batch already inserted — the in-batch
exactness the batched formulation gives by counting duplicates. Filters,
new-B key multisets and per-lane solidity must agree exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from faucet_tpu.config import Config
from faucet_tpu.core import bloom as BL


def _layout(khi, klo, log2_bits, n_hash, shard_bits):
    block, bits = BL._block_and_bits(jnp.asarray(khi), jnp.asarray(klo),
                                     n_hash, log2_bits, shard_bits)
    words = np.asarray(block)[:, None].astype(np.int64) * BL.BLOCK_WORDS \
        + (np.asarray(bits) >> 5)
    return words, np.uint32(1) << (np.asarray(bits) & np.uint32(31))


def _has(words, w, m):
    return bool(np.all(words[w] & m))


def _sequential(a_words, b_words, khi, klo, mask, cfg):
    sb = cfg.shard_bits
    la = cfg.bloom_a_bits.bit_length() - 1
    lb = cfg.bloom_b_bits.bit_length() - 1
    aw, am = _layout(khi, klo, la, cfg.n_hash_a, sb)
    bw, bm = _layout(khi, klo, lb, cfg.n_hash_b, sb)
    a0, b0 = np.array(a_words), np.array(b_words)
    a, b = a0.copy(), b0.copy()
    seen_a, seen_b = set(), set()
    n = len(khi)
    new_b, solid = np.zeros(n, bool), np.zeros(n, bool)
    for i in np.nonzero(mask)[0]:
        key = (int(khi[i]), int(klo[i]))
        in_a = _has(a0, aw[i], am[i]) or key in seen_a
        in_b = _has(b0, bw[i], bm[i]) or key in seen_b
        solid[i] = in_a or in_b
        if in_a:
            new_b[i] = not in_b
            np.bitwise_or.at(b, bw[i], bm[i])
            seen_b.add(key)
        else:
            np.bitwise_or.at(a, aw[i], am[i])
            seen_a.add(key)
    return a, b, new_b, solid


def _keys(rng, n, dup=False):
    khi = rng.integers(0, 1 << 30, size=n).astype(np.uint32)
    klo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    if dup:  # in-batch duplicates, triples included
        khi[n // 2:] = khi[: n - n // 2]
        klo[n // 2:] = klo[: n - n // 2]
        khi[-n // 4:] = khi[: n // 4]
        klo[-n // 4:] = klo[: n // 4]
    return khi, klo


def _check_batch(c, khi, klo, mask, cfg):
    """One batch through both; returns the device cascade after it."""
    want_a, want_b, want_nb, want_solid = _sequential(
        c.a_bloom.words, c.b_bloom.words, khi, klo, mask, cfg)
    c, new_b, solid = BL.cascade_insert_nbs(
        c, jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(mask), cfg)
    np.testing.assert_array_equal(np.asarray(c.a_bloom.words), want_a)
    np.testing.assert_array_equal(np.asarray(c.b_bloom.words), want_b)

    def multiset(flags):
        f = np.asarray(flags)
        return sorted(zip(khi[f].tolist(), klo[f].tolist()))

    assert multiset(new_b) == multiset(want_nb)
    np.testing.assert_array_equal(np.asarray(solid), want_solid)
    return c, np.asarray(new_b), np.asarray(solid)


def _cfg(la, lb, n_shards=1):
    return Config(size_kmer=31, max_read_length=64, n_shards=n_shards,
                  bloom_a_log2_override=la, bloom_b_log2_override=lb)


@pytest.mark.parametrize("la,lb,n,dup", [(18, 16, 500, False),
                                         (20, 17, 2000, True),
                                         (23, 20, 4096, True)])
def test_cascade_matches_sequential(rng, la, lb, n, dup):
    cfg = _cfg(la, lb)
    khi, klo = _keys(rng, n, dup)
    mask = rng.random(n) < 0.9
    c = BL.make_cascade(cfg)
    c, _, _ = _check_batch(c, khi, klo, mask, cfg)
    # a second batch (reversed lanes) exercises the carried A/B state
    _check_batch(c, khi[::-1].copy(), klo[::-1].copy(), mask[::-1].copy(),
                 cfg)


def test_cascade_sharded_addressing(rng):
    """Owner-prefixed addressing (shard_bits=2) follows the same rule."""
    cfg = _cfg(20, 17, n_shards=4)
    assert cfg.shard_bits == 2
    khi, klo = _keys(rng, 1024, dup=True)
    c = BL.make_cascade(cfg)
    c, _, _ = _check_batch(c, khi, klo, np.ones(1024, bool), cfg)
    _check_batch(c, khi, klo, np.ones(1024, bool), cfg)


def test_cascade_all_masked(rng):
    cfg = _cfg(18, 16)
    khi, klo = _keys(rng, 64)
    c, new_b, solid = _check_batch(BL.make_cascade(cfg), khi, klo,
                                   np.zeros(64, bool), cfg)
    assert not np.asarray(c.a_bloom.words).any()
    assert not np.asarray(c.b_bloom.words).any()
    assert not new_b.any() and not solid.any()


def test_cascade_sparse_mask(rng):
    """~3% live lanes: the branch-node endpoint insert's call shape."""
    cfg = _cfg(20, 17)
    khi, klo = _keys(rng, 4096, dup=True)
    mask = rng.random(4096) < 0.03
    c = BL.make_cascade(cfg)
    c, _, _ = _check_batch(c, khi, klo, mask, cfg)
    _check_batch(c, khi, klo, mask, cfg)


def test_cascade_third_batch_mostly_in_b(rng):
    """After two passes over the same keys most are solid: the third
    batch promotes almost nothing and reports almost every lane solid."""
    cfg = _cfg(20, 17)
    khi, klo = _keys(rng, 2048)
    mask = rng.random(2048) < 0.95
    c = BL.make_cascade(cfg)
    for _ in range(2):
        c, _, _ = _check_batch(c, khi, klo, mask, cfg)
    _, new_b, solid = _check_batch(c, khi, klo, mask, cfg)
    assert new_b.sum() <= 0.01 * mask.sum()
    assert solid[mask].all()
