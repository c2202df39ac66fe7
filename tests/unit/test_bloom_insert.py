"""bloom_insert's two paths: the Triton atomicOr kernel compiled for
CUDA devices and the sort-based XLA formulation used elsewhere.

The kernel has no interpret mode (Pallas has no discharge rule for a
masked atomic OR), so the CPU tests cover what surrounds it — the bit
addressing both paths share, sentinel lanes and the choice of path —
and one test marked `gpu` compares the two paths on the card.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from faucet_tpu.core import bloom as BL


def _inputs(rng, n, log2_bits, live=0.9):
    khi = jnp.asarray(rng.integers(0, 1 << 30, n, dtype=np.uint32))
    klo = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                      .astype(np.uint32))
    mask = rng.random(n) < live
    block, h1r, h2 = BL._block_h1r_h2(khi, klo, log2_bits)
    block = jnp.where(jnp.asarray(mask), block, BL._SENTINEL)
    return khi, klo, mask, block, h1r, h2


def _np_or(log2_bits, khi, klo, mask, n_hash):
    block, bits = BL._block_and_bits(khi, klo, n_hash, log2_bits)
    pos = (np.asarray(block)[:, None].astype(np.int64) << BL.BLOCK_BITS) \
        | np.asarray(bits)
    words = np.zeros(1 << (log2_bits - 5), np.uint32)
    pos = pos[mask].ravel()
    np.bitwise_or.at(words, pos >> 5, np.uint32(1) << (pos & 31)
                     .astype(np.uint32))
    return words


def test_bit_addr_matches_probe_layout(rng):
    """The insert addressing sets exactly the bits the probe tests."""
    _, _, mask, block, h1r, h2 = _inputs(rng, 3000, 20)
    n_hash = 5
    word, shift = BL._bit_addr(block[:, None], h1r[:, None], h2[:, None],
                               jnp.arange(1, n_hash + 1, dtype=jnp.uint32))
    bits = BL._probe_bits(h1r, h2, n_hash)
    want = (np.asarray(block)[:, None].astype(np.int64) << BL.BLOCK_BITS) \
        | np.asarray(bits)
    got = (np.asarray(word).astype(np.int64) << 5) | np.asarray(shift)
    np.testing.assert_array_equal(got[mask], want[mask])
    # sentinel lanes address block 0 (and are masked by both paths)
    assert (np.asarray(word)[~mask] < BL.BLOCK_WORDS).all()


@pytest.mark.parametrize("n,live", [(1000, 0.9), (4096, 0.03), (64, 0.0)])
def test_xla_insert_skips_sentinel_lanes(rng, n, live):
    log2_bits, n_hash = 18, 4
    khi, klo, mask, block, h1r, h2 = _inputs(rng, n, log2_bits, live)
    words = jnp.zeros((1 << (log2_bits - 5),), jnp.uint32)
    got = BL._scatter_or_xla(words, block, h1r, h2, n_hash=n_hash)
    np.testing.assert_array_equal(
        np.asarray(got), _np_or(log2_bits, khi, klo, mask, n_hash))
    # bloom_insert on the CPU takes this path
    b = BL.bloom_insert(BL.Bloom(words), khi, klo, jnp.asarray(mask),
                        n_hash, log2_bits)
    np.testing.assert_array_equal(np.asarray(b.words), np.asarray(got))


def test_triton_insert_chosen_only_for_cuda(rng):
    """The choice follows the platform the step is compiled for: the
    CUDA lowering holds the Triton kernel and the CPU lowering does not."""
    khi, klo, mask, _, _, _ = _inputs(rng, 1500, 20)
    b = BL.make_bloom(20)
    fn = jax.jit(lambda b, h, l, m: BL.bloom_insert(b, h, l, m, 3, 20))
    traced = fn.trace(b, khi, klo, jnp.asarray(mask))
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "xla.gpu.triton" in cuda and "bloom_scatter_or" in cuda
    assert "xla.gpu.triton" not in cpu
    # 1500 keys pad to two 1024-key programs
    assert "grid_x = 2" in cuda


@pytest.mark.gpu
def test_triton_insert_equals_xla_on_gpu(rng, gpu):
    log2_bits, n_hash = 24, 7
    _, _, _, block, h1r, h2 = _inputs(rng, 200_000, log2_bits)
    args = jax.device_put((jnp.zeros((1 << (log2_bits - 5),), jnp.uint32),
                           block, h1r, h2), gpu)
    tri = jax.jit(partial(BL._scatter_or_triton, n_hash=n_hash))(*args)
    xla = jax.jit(partial(BL._scatter_or_xla, n_hash=n_hash))(*args)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(xla))
    assert np.asarray(tri).any()
