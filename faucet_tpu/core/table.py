"""Device-resident open-addressing hash map for (hi, lo) k-mer keys.

Reference analogue: ref:src/JunctionMap.{h,cpp}'s
``unordered_map<kmer_type, Junction>`` plus the sink and pair stores
(SURVEY.md §2.1, [C:high]). The device re-design is a struct-of-arrays
open-addressing table living in device memory, updated by *batched* upserts:

1. the batch is sorted by key (two-key lexicographic ``lax.sort``) and
   duplicate keys are pre-combined with segment ops, so each distinct key
   appears once;
2. bounded double-hashing probe rounds run under ``lax.while_loop``; empty
   slots are claimed race-free with a scatter-max "ticket" (classic
   GPU-hash-build trick re-cast onto XLA scatters — deterministic, no
   atomics needed, cf. SURVEY.md §7.1.2);
3. matched keys combine values with per-leaf 'add'/'max' modes.

No deletions: the streaming phases only ever insert/merge; graph cleaning
happens on the extracted compact graph, not in this table.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from faucet_tpu.core.hashing import hash_pair

U32 = jnp.uint32
EMPTY = np.uint32(0xFFFFFFFF)  # keys_hi sentinel: valid k<=31 codes have hi < 2^30


class Table(NamedTuple):
    keys_hi: jnp.ndarray          # uint32[cap]
    keys_lo: jnp.ndarray          # uint32[cap]
    vals: Tuple[jnp.ndarray, ...]  # each [cap, ...]
    count: jnp.ndarray            # int32[] occupied slots
    dropped: jnp.ndarray          # int32[] keys lost to probe-bound overflow

    @property
    def capacity(self) -> int:
        return self.keys_hi.shape[0]


def make(cap: int, val_specs: Tuple[Tuple[tuple, object], ...] = ()) -> Table:
    """val_specs: tuple of (trailing_shape, dtype) per value array."""
    assert cap & (cap - 1) == 0, "capacity must be a power of two"
    vals = tuple(jnp.zeros((cap,) + tuple(s), dtype=d) for s, d in val_specs)
    return Table(
        keys_hi=jnp.full((cap,), EMPTY, dtype=U32),
        keys_lo=jnp.full((cap,), EMPTY, dtype=U32),
        vals=vals,
        count=jnp.zeros((), jnp.int32),
        dropped=jnp.zeros((), jnp.int32),
    )


def _probe_idx(h1, h2, r, cap: int, shard_bits: int = 0):
    """Probe slot for round r. With shard_bits > 0 the table address space
    is partitioned by the key's owner shard (top bits of h1): probing
    stays inside the owner's partition, so slicing the arrays into
    2**shard_bits equal pieces yields exactly the per-shard local tables
    (mirrors bloom._positions; SURVEY.md §7.1.3)."""
    local_cap = cap >> shard_bits  # both static python ints
    idx = (h1 + r.astype(U32) * h2) & np.uint32(local_cap - 1)
    if shard_bits:
        owner = h1 >> np.uint32(32 - shard_bits)
        idx = idx | (owner << np.uint32(local_cap.bit_length() - 1))
    return idx


def _dedupe(khi, klo, vals, mask, modes):
    """Sort batch by key, combine duplicate keys' values; returns sorted
    keys, combined values, and a representative mask."""
    n = khi.shape[0]
    khi_m = jnp.where(mask, khi, EMPTY)
    klo_m = jnp.where(mask, klo, EMPTY)
    iota = jnp.arange(n, dtype=jnp.int32)
    skhi, sklo, sidx = jax.lax.sort((khi_m, klo_m, iota), num_keys=2)
    svals = tuple(v[sidx] for v in vals)
    prev_same = jnp.concatenate(
        [jnp.zeros((1,), bool),
         (skhi[1:] == skhi[:-1]) & (sklo[1:] == sklo[:-1])])
    head = ~prev_same
    seg = jnp.cumsum(head.astype(jnp.int32)) - 1
    combined = []
    for v, mode in zip(svals, modes):
        if mode == "add":
            c = jax.ops.segment_sum(v, seg, num_segments=n,
                                    indices_are_sorted=True)
        elif mode == "max":
            c = jax.ops.segment_max(v, seg, num_segments=n,
                                    indices_are_sorted=True)
        else:
            raise ValueError(f"unknown combine mode {mode!r}")
        combined.append(c[seg])
    rep = head & (skhi != EMPTY)
    return skhi, sklo, tuple(combined), rep


def upsert(tbl: Table, khi, klo, vals: Tuple, mask, modes: Tuple[str, ...],
           max_rounds: int = 128, shard_bits: int = 0) -> Table:
    """Insert-or-combine a batch of keyed values. All shapes static.

    khi/klo: uint32[N]; vals: tuple of [N, ...]; mask: bool[N].
    modes: per-value 'add' | 'max'.
    """
    cap = tbl.capacity
    n = khi.shape[0]
    skhi, sklo, cvals, rep = _dedupe(khi, klo, vals, mask, modes)
    h1, h2 = hash_pair(skhi, sklo)
    ticket = jnp.arange(n, dtype=jnp.int32)
    claim0 = jnp.full((cap,), -1, dtype=jnp.int32)

    def cond(state):
        _, _, pending, r, _, _ = state
        return jnp.any(pending) & (r < max_rounds)

    lanes = jnp.arange(n, dtype=U32)

    def body(state):
        (keys_hi_t, keys_lo_t), tvals, pending, r, claim, n_new = state
        idx = _probe_idx(h1, h2, r, cap, shard_bits)
        cur_hi = keys_hi_t[idx]
        cur_lo = keys_lo_t[idx]
        is_match = pending & (cur_hi == skhi) & (cur_lo == sklo)
        is_empty = pending & (cur_hi == EMPTY)
        # claim empties: highest ticket wins the slot, deterministically
        # (duplicate targets possible -> no uniqueness promise here)
        claim = claim.at[jnp.where(is_empty, idx, cap)].max(
            ticket, mode="drop")
        won = is_empty & (claim[idx] == ticket)

        def uidx(write):
            # dropped lanes get distinct OOB targets so unique_indices
            # holds and XLA emits the vectorized scatter path
            return jnp.where(write, idx, np.uint32(cap) + lanes)

        widx = uidx(won)
        keys_hi_t = keys_hi_t.at[widx].set(skhi, mode="drop",
                                           unique_indices=True)
        keys_lo_t = keys_lo_t.at[widx].set(sklo, mode="drop",
                                           unique_indices=True)
        write = is_match | won
        widx = uidx(write)
        new_tvals = []
        for tv, cv, mode in zip(tvals, cvals, modes):
            # winners start from zero-initialized slots, so add/max both
            # land the combined batch value directly.
            if mode == "add":
                tv = tv.at[widx].add(cv, mode="drop", unique_indices=True)
            else:
                tv = tv.at[widx].max(cv, mode="drop", unique_indices=True)
            new_tvals.append(tv)
        pending = pending & ~write
        n_new = n_new + jnp.sum(won, dtype=jnp.int32)
        return ((keys_hi_t, keys_lo_t), tuple(new_tvals), pending,
                r + 1, claim, n_new)

    init = ((tbl.keys_hi, tbl.keys_lo), tbl.vals, rep,
            jnp.zeros((), jnp.int32), claim0, jnp.zeros((), jnp.int32))
    (keys, tvals, pending, _, _, n_new) = jax.lax.while_loop(cond, body, init)
    return Table(
        keys_hi=keys[0], keys_lo=keys[1], vals=tvals,
        count=tbl.count + n_new,
        dropped=tbl.dropped + jnp.sum(pending, dtype=jnp.int32),
    )


def lookup(tbl: Table, khi, klo, mask, max_rounds: int = 128,
           shard_bits: int = 0):
    """Returns (found bool[N], idx int32[N]); idx valid where found."""
    cap = tbl.capacity
    h1, h2 = hash_pair(khi, klo)

    def cond(state):
        pending, _, _, r = state
        return jnp.any(pending) & (r < max_rounds)

    def body(state):
        pending, found, idx_out, r = state
        idx = _probe_idx(h1, h2, r, cap, shard_bits)
        cur_hi = tbl.keys_hi[idx]
        cur_lo = tbl.keys_lo[idx]
        hit = pending & (cur_hi == khi) & (cur_lo == klo)
        absent = pending & (cur_hi == EMPTY)
        found = found | hit
        idx_out = jnp.where(hit, idx.astype(jnp.int32), idx_out)
        pending = pending & ~hit & ~absent
        return pending, found, idx_out, r + 1

    mask = jnp.asarray(mask, bool)
    # inits derive from varying inputs (mask/h1), not fresh constants:
    # under shard_map the loop outputs are shard-varying and the carry
    # types must match (vma checks; dist/swalk.py routes lookups)
    init = (mask, mask & False,
            (h1 * np.uint32(0)).astype(jnp.int32) - 1,
            jnp.zeros((), jnp.int32))
    _, found, idx_out, _ = jax.lax.while_loop(cond, body, init)
    return found, idx_out


def contains(tbl: Table, khi, klo, mask, max_rounds: int = 128,
             shard_bits: int = 0):
    found, _ = lookup(tbl, khi, klo, mask, max_rounds, shard_bits)
    return found


def occupied_mask(tbl: Table):
    return tbl.keys_hi != EMPTY
