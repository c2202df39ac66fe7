"""Fixed-capacity all-to-all k-mer routing (runs inside shard_map).

Reference status: no communication layer exists in the reference
(single process, SURVEY.md §2.2); this is the multi-device equivalent
the north star mandates — k-mers travel to the shard that owns their hash
range via `lax.all_to_all` between devices, with static per-peer bucket
capacity (XLA needs fixed shapes; SURVEY.md §7.3 "hard parts" #1).

Overflow policy: LOSSLESS. `route_consume` / `route_query` loop over as
many all-to-all rounds as the most-loaded owner needs (carry-to-next-
round; SURVEY.md §7.3 hard-part #1 "without silent drops"): round r
sends each owner's items ranked [r*cap, (r+1)*cap), and the trip count
is the pmax over shards of ceil(max-items-per-owner / cap), so every
shard executes the same number of collectives (no deadlock) and nothing
is dropped no matter how skewed the hash distribution is. Capacity is
still sized ~2x the binomial mean so the common case is ONE round.
One-shot `route()` (capacity >= worst case by construction at its call
sites) still exists for pre-compacted update batches.

Reply routing: `route()` also returns the (owner, rank, ok) placement of
every sent item; `route_back()` inverts the exchange so per-item answers
land back at their origin lanes — the probe/answer round trip of
SURVEY.md §5 "Distributed communication backend".
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from faucet_tpu.dist.mesh import AXIS

I32 = jnp.int32


class RouteInfo(NamedTuple):
    owner: jnp.ndarray   # [n] int32 destination shard per item
    rank: jnp.ndarray    # [n] int32 slot within the peer bucket
    ok: jnp.ndarray      # [n] bool: item was actually sent
    dropped: jnp.ndarray  # [] int32 overflow count


def bucketize(owner, mask, n_shards: int, cap: int) -> RouteInfo:
    """Assign each masked item a (owner, rank<cap) bucket slot."""
    n = owner.shape[0]
    key = jnp.where(mask, owner.astype(I32), n_shards)
    order = jnp.argsort(key, stable=True)
    sorted_key = key[order]
    idx = jnp.arange(n, dtype=I32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_key[1:] != sorted_key[:-1]])
    group_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank_sorted = idx - group_start
    rank = jnp.zeros((n,), I32).at[order].set(rank_sorted,
                                              unique_indices=True)
    ok = mask & (rank < cap)
    dropped = jnp.sum(mask & (rank >= cap), dtype=I32)
    return RouteInfo(owner=key, rank=rank, ok=ok, dropped=dropped)


def _to_buckets(values, info: RouteInfo, n_shards: int, cap: int, fill):
    buf = jnp.full((n_shards, cap) + values.shape[1:], fill,
                   dtype=values.dtype)
    o = jnp.where(info.ok, info.owner, n_shards)
    return buf.at[o, info.rank].set(values, mode="drop")


def route(payload: Dict[str, jnp.ndarray], owner, mask, n_shards: int,
          cap: int, axis: str = AXIS
          ) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray, RouteInfo]:
    """Send each item's payload to its owner shard.

    Returns (received payload dict flattened to [n_shards*cap], received
    mask, RouteInfo for route_back). Must run inside shard_map over
    `axis`.
    """
    info = bucketize(owner, mask, n_shards, cap)
    out = {}
    for name, v in payload.items():
        buf = _to_buckets(v, info, n_shards, cap, 0)
        r = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0,
                               tiled=False)
        out[name] = r.reshape((n_shards * cap,) + v.shape[1:])
    vbuf = _to_buckets(jnp.asarray(mask, jnp.int8), info, n_shards, cap, 0)
    rv = jax.lax.all_to_all(vbuf, axis, split_axis=0, concat_axis=0,
                            tiled=False)
    return out, rv.reshape(n_shards * cap) > 0, info


def _n_rounds(owner, mask, n_shards: int, cap: int, axis: str):
    """Shard-uniform trip count: pmax(ceil(max items per owner / cap)).
    Computed BEFORE the loop so every shard issues the same number of
    collectives (a per-shard data-dependent while_loop would deadlock
    the all_to_all)."""
    counts = jax.ops.segment_sum(
        jnp.asarray(mask, I32), jnp.where(mask, owner.astype(I32), 0),
        num_segments=n_shards)
    local = (jnp.max(counts) + (cap - 1)) // cap
    return jax.lax.pmax(local, axis)


def _round_send(payload, pending, owner, n_shards, cap, axis):
    """One all-to-all round over the currently-pending items."""
    info = bucketize(owner, pending, n_shards, cap)
    out = {}
    for name, v in payload.items():
        buf = _to_buckets(v, info, n_shards, cap, 0)
        r = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0,
                               tiled=False)
        out[name] = r.reshape((n_shards * cap,) + v.shape[1:])
    vbuf = _to_buckets(jnp.asarray(pending, jnp.int8), info, n_shards,
                       cap, 0)
    rv = jax.lax.all_to_all(vbuf, axis, split_axis=0, concat_axis=0,
                            tiled=False)
    return out, rv.reshape(n_shards * cap) > 0, info


def route_consume(payload: Dict[str, jnp.ndarray], owner, mask,
                  n_shards: int, cap: int,
                  consume: Callable, state, axis: str = AXIS):
    """LOSSLESS owner routing for inserts: loops all-to-all rounds until
    every masked item has been delivered, folding each round's received
    items into `state` via consume(state, recv_dict, recv_mask).
    Returns (state, n_unsent) — n_unsent is 0 by construction and exists
    as a tested invariant."""
    rounds = _n_rounds(owner, mask, n_shards, cap, axis)

    def body(_r, carry):
        st, pending = carry
        recv, rmask, info = _round_send(payload, pending, owner, n_shards,
                                        cap, axis)
        st = consume(st, recv, rmask)
        return (st, pending & ~info.ok)

    state, left = jax.lax.fori_loop(0, rounds, body, (state, mask))
    return state, jnp.sum(left, dtype=I32)


def route_query(payload: Dict[str, jnp.ndarray], owner, mask,
                n_shards: int, cap: int, answer: Callable,
                ans_dtype=jnp.int8, fill=0, axis: str = AXIS,
                stats: list = None):
    """LOSSLESS owner-routed query: every masked item reaches its owner
    (multi-round carry), is answered by answer(recv_dict, recv_mask) ->
    [n_shards*cap] array, and the answer returns to the item's lane.
    Returns ([n] answers with `fill` where unmasked, n_unsent==0).

    stats: optional list the (traced) carry-round count is appended to,
    for collective-byte accounting by the caller."""
    n = owner.shape[0]
    rounds = _n_rounds(owner, mask, n_shards, cap, axis)
    if stats is not None:
        stats.append(rounds)
    # init derives from a varying input (owner), not a fresh constant:
    # the loop output is shard-varying (it mixes in routed answers) and
    # shard_map's vma checks require matching carry types
    init = (owner * 0 + fill).astype(ans_dtype)

    def body(_r, carry):
        got, pending = carry
        recv, rmask, info = _round_send(payload, pending, owner, n_shards,
                                        cap, axis)
        ans = answer(recv, rmask).astype(ans_dtype)
        back = route_back(ans, info, n_shards, cap, axis, fill=fill)
        got = jnp.where(info.ok, back, got)
        return (got, pending & ~info.ok)

    got, left = jax.lax.fori_loop(0, rounds, body, (init, mask))
    return got, jnp.sum(left, dtype=I32)


def route_back(answers: jnp.ndarray, info: RouteInfo, n_shards: int,
               cap: int, axis: str = AXIS, fill=0) -> jnp.ndarray:
    """Return per-received-item answers to the shards that asked.

    answers: [n_shards*cap, ...] aligned with route()'s received layout.
    Returns [n_items, ...] aligned with the original items (fill where an
    item was never sent).
    """
    buf = answers.reshape((n_shards, cap) + answers.shape[1:])
    back = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0,
                              tiled=False)
    o = jnp.where(info.ok, info.owner, n_shards)
    got = back.at[o, info.rank].get(mode="fill", fill_value=fill)
    return got
