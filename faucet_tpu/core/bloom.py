"""Bloom filters and the two-level solidity cascade, plus an exact-table
backend with identical call surface.

Reference analogue: ref:src/Bloom.{h,cpp} and the A→B cascade wired in the
driver (SURVEY.md §2.1 "Bloom filter" / "Two-level cascade policy",
[C:high]); the exact backend mirrors the Minia-lineage exact-membership
debug substitute [C:low] and is the golden-test mode (SURVEY.md §7.1.6).

Device design:
- the filter is a uint32 bit-array in device memory; insertion is a
  bitwise OR. On a CUDA device it runs as a Pallas/Triton kernel that
  issues one 32-bit atomicOr per live probe bit (bits OR in any order,
  so the result is deterministic). Elsewhere XLA, which has no OR-
  scatter, runs it as: flatten all probe bit positions, sort, drop
  duplicates, segment-sum the (distinct!) one-hot bit values per word
  (sum of distinct bits == OR), then gather-OR-set each touched word
  exactly once. Both produce the same words bit for bit.
- membership probes are plain row gathers + bit tests, AND-reduced over
  the n_hash probes.

Within-batch cascade semantics: a batch is one "stream moment". Exact
sequential equivalence with the reference's per-read insert is preserved
by counting duplicate canonical k-mers inside the batch: a k-mer occurring
c>=2 times in a batch is solid regardless of filter A (its first
occurrence would have primed A for the second).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from faucet_tpu.core import table as T
from faucet_tpu.core.hashing import hash_pair

U32 = jnp.uint32
_SENTINEL = np.uint32(0xFFFFFFFF)


# ---- plain Bloom filter ------------------------------------------------


class Bloom(NamedTuple):
    words: jnp.ndarray  # uint32[2**log2_bits / 32]


def make_bloom(log2_bits: int) -> Bloom:
    assert log2_bits >= 5
    return Bloom(words=jnp.zeros((1 << (log2_bits - 5),), dtype=U32))


BLOCK_BITS = 9          # 512-bit blocks = 16 words = 64 B
BLOCK_WORDS = 1 << (BLOCK_BITS - 5)


def _block_h1r_h2(khi, klo, log2_bits: int, shard_bits: int = 0):
    """Shared blocked-Bloom addressing: (block index, rotated h1, h2).

    bit_j of a key = (h1r + (j+1)*h2) & 511 inside `block` — the single
    source of truth for the probe and for both insert paths."""
    h1, h2 = hash_pair(khi, klo)
    local_block_bits = log2_bits - shard_bits - BLOCK_BITS
    block = h1 & np.uint32((1 << local_block_bits) - 1)
    if shard_bits:
        owner = (h1 >> np.uint32(32 - shard_bits)).astype(U32)
        block = block | (owner << np.uint32(local_block_bits))
    # bit stream decorrelated from the block choice via h1's high half
    h1r = (h1 >> np.uint32(16)) | (h1 << np.uint32(16))
    return block, h1r, h2


def _block_and_bits(khi, klo, n_hash: int, log2_bits: int,
                    shard_bits: int = 0):
    """Blocked-Bloom addressing: all n_hash probe bits of a key live in
    ONE 512-bit block, so a probe is a single contiguous 64 B row gather
    instead of n_hash scattered word gathers: one 64 B row is two 32 B
    memory sectors (same design as GPU Bloom k-mer filters, PAPERS.md
    cuSBF). Costs ~1.2x bits for equal fp at 1% — absorbed by pow2
    sizing.

    The top shard_bits of the BLOCK address come from the key's owner
    shard (top bits of h1), so the array is a hash-range partition:
    slicing into 2**shard_bits pieces yields the per-shard local filters
    (SURVEY.md §7.1.3).

    Returns (block uint32[...], bits uint32[..., n_hash] in [0, 512)).
    """
    block, h1r, h2 = _block_h1r_h2(khi, klo, log2_bits, shard_bits)
    return block, _probe_bits(h1r, h2, n_hash)


def _probe_bits(h1r, h2, n_hash: int):
    """bits uint32[..., n_hash] in [0, 512): bit_j = (h1r + (j+1)*h2)."""
    i = jnp.arange(1, n_hash + 1, dtype=U32)
    return (h1r[..., None] + i * h2[..., None]) \
        & np.uint32((1 << BLOCK_BITS) - 1)


def _bit_addr(block, h1r, h2, i):
    """Insert addressing of probe bit i (1-based; i and the key arrays
    broadcast): (word index int32, bit-in-word uint32). Sentinel-block
    lanes get block 0's words; callers mask them."""
    bit = (h1r + i * h2) & np.uint32((1 << BLOCK_BITS) - 1)
    base = jnp.where(block != _SENTINEL, block, 0).astype(jnp.int32) \
        * BLOCK_WORDS
    return base + (bit >> np.uint32(5)).astype(jnp.int32), \
        bit & np.uint32(31)


_OR_KEYS = 1024   # keys per Triton program


def _scatter_or_kernel(block_ref, h1r_ref, h2_ref, _words_in, words_ref, *,
                       n_hash: int):
    block = block_ref[...]
    live = block != _SENTINEL
    h1r, h2 = h1r_ref[...], h2_ref[...]
    for i in range(1, n_hash + 1):
        word, shift = _bit_addr(block, h1r, h2, np.uint32(i))
        plt.atomic_or(words_ref, word, np.uint32(1) << shift, mask=live)


def _scatter_or_triton(words, block, h1r, h2, *, n_hash: int):
    """CUDA insert: one program per _OR_KEYS keys, one 32-bit atomicOr
    per live probe bit straight into the filter (aliased in place);
    sentinel lanes issue no atomic."""
    assert words.shape[0] < (1 << 31)
    pad = (-block.shape[0]) % _OR_KEYS
    if pad:
        fill = lambda a, v: jnp.concatenate(
            [a, jnp.full((pad,), v, U32)])
        block, h1r, h2 = fill(block, _SENTINEL), fill(h1r, 0), fill(h2, 0)
    keys = pl.BlockSpec((_OR_KEYS,), lambda i: (i,))
    return pl.pallas_call(
        partial(_scatter_or_kernel, n_hash=n_hash),
        grid=(block.shape[0] // _OR_KEYS,),
        in_specs=[keys, keys, keys, pl.no_block_spec],
        out_specs=pl.no_block_spec,
        out_shape=jax.ShapeDtypeStruct(words.shape, U32),
        input_output_aliases={3: 0},
        backend="triton", name="bloom_scatter_or",
    )(block, h1r, h2, words)


def _scatter_or_xla(words, block, h1r, h2, *, n_hash: int):
    """Portable insert: sort the bit positions, OR distinct bits per word
    by segment sums, write each touched word once."""
    word, shift = _bit_addr(block[:, None], h1r[:, None], h2[:, None],
                            jnp.arange(1, n_hash + 1, dtype=U32))
    pos = jnp.where((block != _SENTINEL)[:, None],
                    (word.astype(U32) << np.uint32(5)) | shift,
                    _SENTINEL).reshape(-1)
    pos = jax.lax.sort(pos)
    uniq = jnp.concatenate(
        [jnp.ones((1,), bool), pos[1:] != pos[:-1]]) & (pos != _SENTINEL)
    word = pos >> np.uint32(5)
    one = jnp.where(uniq, np.uint32(1) << (pos & np.uint32(31)),
                    np.uint32(0))
    # group by word: distinct bits per word sum to their OR
    new_word = jnp.concatenate(
        [jnp.ones((1,), bool), word[1:] != word[:-1]])
    seg = jnp.cumsum(new_word.astype(jnp.int32)) - 1
    n = pos.shape[0]
    # seg ids are sorted: lets XLA vectorize the underlying scatters
    orv = jax.ops.segment_sum(one, seg, num_segments=n,
                              indices_are_sorted=True)
    segword = jax.ops.segment_max(jnp.where(uniq, word, np.uint32(0)),
                                  seg, num_segments=n,
                                  indices_are_sorted=True)
    seg_live = jax.ops.segment_max(uniq.astype(jnp.int32), seg,
                                   num_segments=n,
                                   indices_are_sorted=True) > 0
    # segment representatives carry unique, ascending word indices; dead
    # segments trail (sentinels sort last) and get unique OOB indices so
    # the sorted/unique promises hold and XLA vectorizes the scatter
    W = words.shape[0]
    dead_idx = np.uint32(W) + jnp.arange(n, dtype=U32)
    idx = jnp.where(seg_live, segword, dead_idx)
    cur = words.at[jnp.where(seg_live, segword, 0)].get(mode="clip")
    return words.at[idx].set(cur | orv, mode="drop",
                             indices_are_sorted=True, unique_indices=True)


def bloom_insert(b: Bloom, khi, klo, mask, n_hash: int,
                 log2_bits: int, shard_bits: int = 0) -> Bloom:
    """OR all probe bits of the masked keys into the filter.

    khi/klo/mask: 1-D [N]. The path follows the platform the step is
    compiled for: the Triton atomicOr kernel on CUDA, the sort-based
    XLA formulation everywhere else (same result bit for bit)."""
    block, h1r, h2 = _block_h1r_h2(khi, klo, log2_bits, shard_bits)
    block = jnp.where(mask, block, _SENTINEL)
    return Bloom(words=jax.lax.platform_dependent(
        b.words, block, h1r, h2,
        cuda=partial(_scatter_or_triton, n_hash=n_hash),
        default=partial(_scatter_or_xla, n_hash=n_hash)))


def bloom_contains(b: Bloom, khi, klo, mask, n_hash: int, log2_bits: int,
                   shard_bits: int = 0):
    """Membership probes: one 64 B row gather per key + bit tests."""
    block, bits = _block_and_bits(khi, klo, n_hash, log2_bits, shard_bits)
    rows = b.words.reshape(-1, BLOCK_WORDS)[block.reshape(-1)]
    rows = rows.reshape(block.shape + (BLOCK_WORDS,))
    w = jnp.take_along_axis(rows, (bits >> np.uint32(5)).astype(jnp.int32),
                            axis=-1)
    bit = (w >> (bits & np.uint32(31))) & np.uint32(1)
    return jnp.all(bit == 1, axis=-1) & mask


# ---- solidity cascade (two Blooms, or two exact tables) ----------------


class Cascade(NamedTuple):
    """Filter A (seen >= 1) and filter B (solid, seen >= 2)."""
    a_bloom: Bloom
    b_bloom: Bloom
    a_table: T.Table
    b_table: T.Table


def make_cascade(cfg) -> Cascade:
    # unused halves are dummy-sized but must stay splittable into
    # n_shards pieces (one block each) for the sharded PartitionSpec
    dummy_log2 = BLOCK_BITS + cfg.shard_bits
    dummy_cap = max(2, 2 * cfg.n_shards)
    if cfg.exact:
        return Cascade(make_bloom(dummy_log2), make_bloom(dummy_log2),
                       T.make(cfg.cascade_cap_a), T.make(cfg.cascade_cap_b))
    return Cascade(make_bloom(cfg.bloom_a_bits.bit_length() - 1),
                   make_bloom(cfg.bloom_b_bits.bit_length() - 1),
                   T.make(dummy_cap), T.make(dummy_cap))


def _batch_counts(khi, klo, mask):
    """Sorted batch keys + per-representative occurrence count + the
    original lane index of each sorted position (stable, so the
    representative is the key's first in-batch occurrence)."""
    n = khi.shape[0]
    khi_m = jnp.where(mask, khi, _SENTINEL)
    klo_m = jnp.where(mask, klo, _SENTINEL)
    iota = jnp.arange(n, dtype=jnp.int32)
    skhi, sklo, sidx = jax.lax.sort((khi_m, klo_m, iota), num_keys=2)
    head = jnp.concatenate(
        [jnp.ones((1,), bool),
         (skhi[1:] != skhi[:-1]) | (sklo[1:] != sklo[:-1])])
    seg = jnp.cumsum(head.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(jnp.ones((n,), jnp.int32), seg,
                                 num_segments=n)[seg]
    rep = head & (skhi != _SENTINEL)
    return skhi, sklo, counts, rep, sidx


def cascade_insert(c: Cascade, khi, klo, mask, cfg) -> Cascade:
    """Phase-1 load: if A contains k: B.add(k) else A.add(k), batched
    (SURVEY.md §A.2), preserving sequential semantics via in-batch counts.
    """
    return cascade_insert_nb(c, khi, klo, mask, cfg)[0]


def cascade_insert_nb(c: Cascade, khi, klo, mask, cfg
                      ) -> Tuple[Cascade, jnp.ndarray]:
    c, new_b, _ = cascade_insert_nbs(c, khi, klo, mask, cfg)
    return c, new_b


def cascade_insert_nbs(c: Cascade, khi, klo, mask, cfg
                       ) -> Tuple[Cascade, jnp.ndarray, jnp.ndarray]:
    """cascade_insert + per-lane (new_b, solid) flags: new_b[i] is True
    on exactly the lane whose insert first promoted its k-mer into B
    (drives the branch-node cascade, core/nodes.py); solid[i] is B
    membership as of the lane's OWN insert — the streaming scan's window
    solidity, produced for free by the insert pass instead of a second
    probe pass (one fewer probe per window in single-pass mode).

    One sort groups the batch by key. Each key's first occurrence is its
    representative: it probes A and B as they stood before the batch,
    and its occurrence count stands in for the in-batch A priming, so
    the filters equal the reference's key-by-key "if A has k: add to B,
    else add to A" exactly. solid uses the same at-its-turn rule: in B
    before, in A before, or any earlier in-batch occurrence.
    """
    sb = cfg.shard_bits
    n = khi.shape[0]
    skhi, sklo, counts, rep, sidx = _batch_counts(khi, klo, mask)
    # per-lane occurrence rank within its sorted key group (stable sort:
    # rank 0 is the first in-batch occurrence)
    head = jnp.concatenate(
        [jnp.ones((1,), bool),
         (skhi[1:] != skhi[:-1]) | (sklo[1:] != sklo[:-1])])
    iota = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(head, iota, 0))
    rank = iota - seg_start
    if cfg.exact:
        in_a = T.contains(c.a_table, skhi, sklo, rep, shard_bits=sb)
        in_b = T.contains(c.b_table, skhi, sklo, rep, shard_bits=sb)
        add_b = rep & (in_a | (counts >= 2))
        new_b = jnp.zeros((n,), bool).at[sidx].set(add_b & ~in_b)
        sol_sorted = (in_b[seg_start] | in_a[seg_start] | (rank >= 1)) \
            & (skhi != _SENTINEL)
        solid = jnp.zeros((n,), bool).at[sidx].set(sol_sorted)
        return c._replace(
            a_table=T.upsert(c.a_table, skhi, sklo, (), rep & ~in_a,
                             modes=(), shard_bits=sb),
            b_table=T.upsert(c.b_table, skhi, sklo, (), add_b, modes=(),
                             shard_bits=sb)), new_b, solid
    la = cfg.bloom_a_bits.bit_length() - 1
    lb = cfg.bloom_b_bits.bit_length() - 1
    in_a = bloom_contains(c.a_bloom, skhi, sklo, rep, cfg.n_hash_a, la, sb)
    in_b = bloom_contains(c.b_bloom, skhi, sklo, rep, cfg.n_hash_b, lb, sb)
    add_b = rep & (in_a | (counts >= 2))
    add_a = rep & ~in_a
    new_b = jnp.zeros((n,), bool).at[sidx].set(add_b & ~in_b)
    sol_sorted = (in_b[seg_start] | in_a[seg_start] | (rank >= 1)) \
        & (skhi != _SENTINEL)
    solid = jnp.zeros((n,), bool).at[sidx].set(sol_sorted)
    return c._replace(
        a_bloom=bloom_insert(c.a_bloom, skhi, sklo, add_a, cfg.n_hash_a,
                             la, sb),
        b_bloom=bloom_insert(c.b_bloom, skhi, sklo, add_b, cfg.n_hash_b,
                             lb, sb)), new_b, solid


def cascade_solid(c: Cascade, khi, klo, mask, cfg):
    """Membership in B — the only query the graph phases use."""
    sb = cfg.shard_bits
    if cfg.exact:
        shape = khi.shape
        f = T.contains(c.b_table, khi.reshape(-1), klo.reshape(-1),
                       jnp.asarray(mask).reshape(-1), shard_bits=sb)
        return f.reshape(shape)
    lb = cfg.bloom_b_bits.bit_length() - 1
    return bloom_contains(c.b_bloom, khi, klo, mask, cfg.n_hash_b, lb, sb)
