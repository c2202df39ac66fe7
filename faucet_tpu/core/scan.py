"""Phase-2 device scan: dense junction detection over read batches.

Reference analogue: ref:src/ReadScanner.{h,cpp} `scanReads`/`scanInputRead`
(SURVEY.md §2.1, §3.2 [C:high]). The reference hops junction-to-junction
per read, skipping linear stretches via stored distances — a latency
optimization for a serial CPU. On the accelerator we invert the design
(SURVEY.md §7.1.1): probe EVERY window of EVERY read against solid
filter B in one batched 8-way extension probe; junction-ness is then a
pure function of (k-mer, B), so the dense scan and the reference's
sequential scan agree on the junction set by construction.

Per batch:
  1. kmerize -> per-window canonical codes           [B, P]
  2. solidity probe of windows and their 8 slot-extensions
  3. segment rows into maximal solid runs (two lax.scans over P)
  4. junction records: per-slot cov (+1 per observed traversal) and dist
     (max bases to next junction / run end) -> batched table upsert
  5. runs containing no junction contribute their two end k-mers as sink
     anchors (SURVEY.md §A.4 caps)
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from faucet_tpu.core import bloom as BL
from faucet_tpu.core import kmer as KM
from faucet_tpu.core import table as T
from faucet_tpu.core import u32x2 as u2
from faucet_tpu.core.slots import entry_slot, exit_slot

I32 = jnp.int32


class ScanResult(NamedTuple):
    junctions: T.Table
    sinks: T.Table
    n_solid: jnp.ndarray      # solid windows in batch
    n_junc_pos: jnp.ndarray   # junction-window observations in batch
    jm: jnp.ndarray           # [B, P] junction mask (consumed by pairs)
    canon_hi: jnp.ndarray     # [B, P] (consumed by pairs)
    canon_lo: jnp.ndarray
    jspool: object = None     # JSpool carry when spooling (see below)
    traversals: object = None  # per-k-mer slot counts (see scan_batch)


class JSpool(NamedTuple):
    """Cross-batch junction-update spool (round-4 perf, VERDICT r3 #2).

    The scan NEVER reads the junction table — it only upserts add/max-
    commutative records — so table maintenance can be deferred: each
    batch appends its compacted junction lanes (slim sf/dd packing, as
    routed by dist/sharded.py) to this device buffer, and a FLUSH sorts the
    spool by key, pre-combines duplicates (the same junction recurs
    every ~1/coverage batches), and upserts only unique representatives.
    The per-batch junction-table upsert becomes a per-flush cost
    amortized over dozens of batches. Semantically invisible: flushes
    happen before anything reads the table (phase end, checkpoint,
    build), and combining is associative/commutative."""
    khi: jnp.ndarray   # uint32[S]
    klo: jnp.ndarray   # uint32[S]
    sf: jnp.ndarray    # uint32[S] ex_slot | en_slot<<3 | exit_ok<<6 | entry_ok<<7
    dd: jnp.ndarray    # uint32[S] ex_dist | en_dist<<16
    cnt: jnp.ndarray   # int32[] valid lanes


def make_jspool(cfg) -> JSpool:
    """Spool sized so one batch always fits after a flush."""
    need = cfg.batch_reads * cfg.positions_per_read + cfg.scan_update_cap
    S = 1 << (need - 1).bit_length()
    u = lambda: jnp.zeros((S,), jnp.uint32)
    return JSpool(khi=u(), klo=u(), sf=u(), dd=u(),
                  cnt=jnp.zeros((), I32))


def spool_flush(junctions: T.Table, spool: JSpool, cfg
                ) -> Tuple[T.Table, JSpool]:
    """Drain the spool into the junction table: one 2-key sort groups
    duplicate keys, cov/dist one-hots combine per key (segment ops),
    and only unique representatives go through table upsert rounds."""
    S = spool.khi.shape[0]
    valid = jnp.arange(S, dtype=I32) < spool.cnt
    khi_m = jnp.where(valid, spool.khi, np.uint32(0xFFFFFFFF))
    klo_m = jnp.where(valid, spool.klo, np.uint32(0xFFFFFFFF))
    skhi, sklo, ssf, sdd = jax.lax.sort(
        (khi_m, klo_m, spool.sf, spool.dd), num_keys=2)
    cov8, dist8 = cov_dist8(
        (ssf & 7).astype(I32), ((ssf >> 3) & 7).astype(I32),
        (sdd & 0xFFFF).astype(I32), (sdd >> 16).astype(I32),
        (ssf >> 6) & 1 > 0, (ssf >> 7) & 1 > 0)
    head = jnp.concatenate(
        [jnp.ones((1,), bool),
         (skhi[1:] != skhi[:-1]) | (sklo[1:] != sklo[:-1])])
    seg = jnp.cumsum(head.astype(I32)) - 1
    cov8c = jax.ops.segment_sum(cov8, seg, num_segments=S,
                                indices_are_sorted=True)[seg]
    dist8c = jax.ops.segment_max(dist8.astype(I32), seg, num_segments=S,
                                 indices_are_sorted=True)[seg] \
        .astype(jnp.uint16)
    rep = head & (skhi != np.uint32(0xFFFFFFFF))
    K = min(S, cfg.scan_update_cap)

    def fn(tbl, cm, ps):
        return T.upsert(tbl, ps[0], ps[1], (ps[2], ps[3]), cm,
                        modes=("add", "max"), shard_bits=cfg.shard_bits)

    junctions, _ = upsert_rounds(rep, K, (skhi, sklo, cov8c, dist8c),
                                 fn, junctions)
    return junctions, spool._replace(cnt=jnp.zeros((), I32))


def _spool_append(junctions: T.Table, spool: JSpool, u: "ScanUpdates",
                  cfg) -> Tuple[T.Table, JSpool]:
    """Append this batch's junction lanes to the spool, flushing first
    when they would not fit (spool capacity guarantees one batch always
    fits after a flush — see make_jspool)."""
    B, P = u.is_junc.shape
    flat = lambda a: a.reshape((B * P,))
    jm = flat(u.is_junc)
    sf = (flat(u.ex_slot).astype(jnp.uint32)
          | (flat(u.en_slot).astype(jnp.uint32) << 3)
          | (flat(u.exit_ok).astype(jnp.uint32) << 6)
          | (flat(u.entry_ok).astype(jnp.uint32) << 7))
    dd = (flat(u.ex_dist).astype(jnp.uint32) & 0xFFFF) \
        | ((flat(u.en_dist).astype(jnp.uint32) & 0xFFFF) << 16)
    khi, klo = flat(u.key_hi), flat(u.key_lo)
    n = jm.shape[0]
    total = jnp.sum(jm, dtype=I32)
    K = min(n, cfg.scan_update_cap)
    S = spool.khi.shape[0]

    # flush-first when the batch might not fit: the last append round
    # writes a full K-lane window (dead tail lanes beyond cnt hold
    # EMPTY keys and are overwritten by the next append), so reserve K
    junctions, spool = jax.lax.cond(
        spool.cnt + total > S - K,
        lambda js: spool_flush(js[0], js[1], cfg),
        lambda js: js, (junctions, spool))

    order = jnp.argsort(~jm, stable=True).astype(I32)
    padn = (-n) % K
    if padn:
        order = jnp.concatenate([order, jnp.full((padn,), n, I32)])
    jm_p = jnp.concatenate([jm, jnp.zeros((1,), bool)])
    rounds = (total + (K - 1)) // K
    cnt0 = spool.cnt

    def body(r, sp):
        take = jax.lax.dynamic_slice(order, (r * K,), (K,))
        cm = jm_p[jnp.minimum(take, n)]
        off = cnt0 + r * K
        wr = lambda dst, src, fill: jax.lax.dynamic_update_slice(
            dst, jnp.where(cm, src[jnp.minimum(take, n - 1)],
                           jnp.uint32(fill)), (off,))
        return sp._replace(
            khi=wr(sp.khi, khi, 0xFFFFFFFF),
            klo=wr(sp.klo, klo, 0xFFFFFFFF),
            sf=wr(sp.sf, sf, 0), dd=wr(sp.dd, dd, 0))

    spool = jax.lax.fori_loop(0, rounds, body, spool)
    return junctions, spool._replace(cnt=cnt0 + total)


def _row_runs(solid, is_junc):
    """Per-row maximal solid-run bookkeeping, fully vectorized.

    Returns (run_start_idx, run_end_idx, prev_junc_idx, next_junc_idx,
    run_junc_total), all [B, P] int32; *_junc_idx are -1 when absent,
    strictly before/after the position within its run.

    Formulated as cumulative max/min ONLY — no per-element gathers
    (`take_along_axis` over the [B, P] grid would be a 573k-element XLA
    gather per field); instead, the value needed
    at the latest/earliest flagged position is PACKED with the position
    ((pos+1)*stride + value) and propagated with the same cummax — the
    max picks the latest flagged position, the mod recovers its value.
    Semantics are bit-identical to the sequential recurrence (incl.
    run-start resets and the strictly-before/after junction indexing),
    verified lane-for-lane in tests/unit/test_scan_runs.py.
    """
    B, P = solid.shape
    # ADVICE r4: the pack-and-propagate trick below computes
    # (pos+1)*(2P+2)+cj*2+ji in int32, which silently overflows once
    # P exceeds ~2^15 (a long-read config with max_read_length ~32.8k+k)
    assert P < (1 << 15), (
        f"_row_runs packed-propagation overflows int32 at P={P} "
        f"(max_read_length - k + 1 must stay < 32768)")
    prev_solid = jnp.pad(solid[:, :-1], ((0, 0), (1, 0)))
    next_solid = jnp.pad(solid[:, 1:], ((0, 0), (0, 1)))
    start_m = solid & ~prev_solid
    end_m = solid & ~next_solid
    pos = jnp.broadcast_to(jnp.arange(P, dtype=I32)[None, :], (B, P))
    BIG = jnp.int32(P)  # > any index; stands in for +inf

    # forward: run start = latest start position <= p (0 before any);
    # prev junction = latest junction strictly before p, -1 if it
    # precedes the latest reset (= run start).
    rs = jax.lax.cummax(jnp.where(start_m, pos, 0), axis=1)
    jmax = jax.lax.cummax(jnp.where(is_junc, pos, -1), axis=1)
    jmax_excl = jnp.pad(jmax[:, :-1], ((0, 0), (1, 0)),
                        constant_values=-1)
    pj = jnp.where(jmax_excl >= rs, jmax_excl, -1)
    # junctions-in-run count up to and including p: inclusive cumsum
    # minus the cumsum just before the run start. The value pair
    # (cj, is_junc) AT position rs rides the same propagation as rs
    # itself: packed = (pos+1)*VS + cj*2 + is_junc at flagged positions
    # (position 0 always flagged — the plain-rs gather clamps there when
    # no start precedes p), cummax picks the latest, mod decodes.
    ji = is_junc.astype(I32)
    cj = jnp.cumsum(ji, axis=1)
    VS = jnp.int32(2 * P + 2)   # packed values cj*2+junc < VS
    fw = jax.lax.cummax(
        jnp.where(start_m | (pos == 0), (pos + 1) * VS + cj * 2 + ji, 0),
        axis=1)
    at_rs = fw % VS
    cnt_incl = cj - at_rs // 2 + at_rs % 2

    # backward: run end = earliest end >= p (0 if none, matching the
    # sequential init); next junction = earliest junction strictly
    # after p and not past the next end boundary (-1 at end positions).
    rcummin = lambda a: jnp.flip(
        jax.lax.cummin(jnp.flip(a, axis=1), axis=1), axis=1)
    emin = rcummin(jnp.where(end_m, pos, BIG))
    re = jnp.where(emin < BIG, emin, 0)
    jmin = rcummin(jnp.where(is_junc, pos, BIG))
    jmin_excl = jnp.pad(jmin[:, 1:], ((0, 0), (0, 1)),
                        constant_values=P)
    emin_excl = jnp.pad(emin[:, 1:], ((0, 0), (0, 1)),
                        constant_values=P)
    nj = jnp.where((~end_m) & (jmin_excl <= emin_excl)
                   & (jmin_excl < BIG), jmin_excl, -1)
    # run-junction total = cnt_incl at the run END, propagated backward
    # with the same packing trick ((BIG-pos) makes the EARLIEST end win
    # the reverse cummax); 0 when no end follows (emin == BIG).
    VS2 = jnp.int32(P + 1)      # cnt_incl <= P
    rcummax = lambda a: jnp.flip(
        jax.lax.cummax(jnp.flip(a, axis=1), axis=1), axis=1)
    bw = rcummax(jnp.where(end_m, (BIG - pos) * VS2 + cnt_incl, 0))
    tot = jnp.where(bw > 0, bw % VS2, 0)
    return rs, re, pj, nj, tot, start_m, end_m


class ScanUpdates(NamedTuple):
    """Per-window update grids produced by scan_core; consumers compact
    the sparse live lanes (branch points + read ends) into
    cfg.scan_update_cap-lane rounds via upsert_rounds — XLA scatter and
    routing-buffer cost scale with the lane cap, and NOTHING is dropped:
    a junction-saturated batch just takes more rounds (VERDICT r1 #3).

    The per-slot cov/dist one-hots are NOT materialized as dense
    [B, P, 8] grids (pure memory traffic for grids that are >95% dead
    lanes). scan_core returns the slim
    [B, P] slot/dist/flag fields; cov_dist8() expands the gathered
    K-lane rounds to [K, 8] right before the table upsert — bit-
    identical values, 8x less glue traffic (VERDICT r3 #2)."""
    is_junc: jnp.ndarray    # [B, P] junction-window mask
    ex_slot: jnp.ndarray    # [B, P] i32 exit slot (0..7)
    en_slot: jnp.ndarray    # [B, P] i32 entry slot (0..7)
    ex_dist: jnp.ndarray    # [B, P] i32 bases to next junction/run end
    en_dist: jnp.ndarray    # [B, P] i32 bases from prev junction/start
    exit_ok: jnp.ndarray    # [B, P] bool exit-slot traversal observed
    entry_ok: jnp.ndarray   # [B, P] bool entry-slot traversal observed
    exit_any: jnp.ndarray   # [B, P] bool exit traversal of any solid window
    entry_any: jnp.ndarray  # [B, P] bool entry traversal, any solid window
    sink_pos: jnp.ndarray   # [B, P] sink-anchor mask
    sink_cov: jnp.ndarray   # [B, P]
    key_hi: jnp.ndarray     # [B, P] table keys
    key_lo: jnp.ndarray
    words: jnp.ndarray      # [B, P, 4] wide canon words ([B, P, 0] narrow)
    jm: jnp.ndarray         # alias of is_junc (consumed by pairs)
    canon_hi: jnp.ndarray   # [B, P] (consumed by pairs)
    canon_lo: jnp.ndarray
    n_solid: jnp.ndarray
    n_junc_pos: jnp.ndarray


def cov_dist8(ex_slot, en_slot, ex_dist, en_dist, exit_ok, entry_ok):
    """Expand slim per-lane slot/dist/flag fields to the (cov8, dist8)
    junction-record update rows (SURVEY.md §A.3 slots). Applied to
    compacted [K] rounds, not the dense grid."""
    sl8 = jnp.arange(8, dtype=I32)
    ex_oh = (ex_slot[..., None] == sl8).astype(I32) \
        * exit_ok[..., None].astype(I32)
    en_oh = (en_slot[..., None] == sl8).astype(I32) \
        * entry_ok[..., None].astype(I32)
    cov8 = ex_oh + en_oh
    dist8 = jnp.maximum(ex_oh * ex_dist[..., None],
                        en_oh * en_dist[..., None]).astype(jnp.uint16)
    return cov8, dist8


def upsert_rounds(mask, K: int, payloads, fn, state, sync=None):
    """Fold every True lane of a sparse update grid into `state`, K
    compacted lanes per round: state = fn(state, round_mask[K],
    round_payloads) for ceil(live/K) rounds, keeping original lane order
    (deterministic). `sync` maps the round count (e.g. lax.pmax over the
    mesh axis so every shard issues the same collectives). Lossless by
    construction: one stable argsort puts the live lanes first, in
    order."""
    n = mask.shape[0]
    total = jnp.sum(mask, dtype=I32)
    rounds = (total + (K - 1)) // K
    if sync is not None:
        rounds = sync(rounds)

    order = jnp.argsort(~mask, stable=True).astype(I32)
    padn = (-n) % K
    # pad so no round's dynamic slice clamps back into a previous
    # round's lanes (index n reads mask False, payload rows clamp+mask)
    if padn:
        order = jnp.concatenate([order, jnp.full((padn,), n, I32)])
    maskp = jnp.concatenate([mask, jnp.zeros((1,), bool)])

    def body(r, st):
        take = jax.lax.dynamic_slice(order, (r * K,), (K,))
        cm = maskp[jnp.minimum(take, n)]
        return fn(st, cm, tuple(p[take] for p in payloads))

    return jax.lax.fori_loop(0, rounds, body, state), total


def scan_batch(cascade: BL.Cascade, junctions: T.Table, sinks: T.Table,
               bases, lens, cfg, node_cascade: BL.Cascade = None,
               window_solid=None, jspool: JSpool = None,
               traversals: T.Table = None) -> ScanResult:
    """Single-shard scan: membership and tables are local.

    window_solid: optional precomputed [B, P] B-membership of the
    windows (the single-pass streaming path reuses the insert pass's
    flags instead of re-probing).

    jspool: optional junction-update spool (narrow keys only). When
    passed, junction lanes append to the spool instead of upserting
    per-batch; the caller owns flushing (Pipeline flushes at phase
    ends; spool_flush). Sinks always upsert directly (random-position
    anchors have no cross-batch duplication to amortize).

    traversals: optional table of per-slot traversal counts of EVERY
    solid window, not only junction windows (single-pass streams; see
    make_traversals)."""
    solid_fn = lambda khi, klo, m: BL.cascade_solid(cascade, khi, klo, m,
                                                    cfg)
    node_fn = None
    if node_cascade is not None and cfg.use_node_junctions:
        ncfg = cfg.node_view()
        node_fn = lambda khi, klo, m: BL.cascade_solid(node_cascade, khi,
                                                       klo, m, ncfg)
    u = scan_core(solid_fn, bases, lens, cfg, node_solid_fn=node_fn,
                  window_solid=window_solid)
    wide = cfg.size_kmer > 31
    B, P = u.is_junc.shape
    flat = lambda a: a.reshape((B * P,) + a.shape[2:])
    K = min(B * P, cfg.scan_update_cap)

    if jspool is not None and not wide:
        junctions, jspool = _spool_append(junctions, jspool, u, cfg)
    else:
        def jfn(tbl, cm, ps):
            jhi, jlo, exs, ens, exd, end_, exo, eno, words = ps
            cov8, dist8 = cov_dist8(exs, ens, exd, end_, exo, eno)
            return T.upsert(tbl, jhi, jlo,
                            (cov8, dist8) + ((words,) if wide else ()),
                            cm,
                            modes=("add", "max")
                            + (("max",) if wide else ()),
                            shard_bits=cfg.shard_bits)

        junctions, _ = upsert_rounds(
            flat(u.is_junc), K,
            (flat(u.key_hi), flat(u.key_lo), flat(u.ex_slot),
             flat(u.en_slot), flat(u.ex_dist), flat(u.en_dist),
             flat(u.exit_ok), flat(u.entry_ok), flat(u.words)),
            jfn, junctions)

    def sfn(tbl, cm, ps):
        shi, slo, scov, words = ps
        return T.upsert(tbl, shi, slo,
                        (scov,) + ((words,) if wide else ()), cm,
                        modes=("add",) + (("max",) if wide else ()),
                        shard_bits=cfg.shard_bits)

    sinks, _ = upsert_rounds(
        flat(u.sink_pos), K,
        (flat(u.key_hi), flat(u.key_lo), flat(u.sink_cov),
         flat(u.words)), sfn, sinks)

    if traversals is not None:
        # dense (most solid windows traverse): one upsert of the batch
        zero = jnp.zeros((B * P,), I32)
        cov8, _ = cov_dist8(flat(u.ex_slot), flat(u.en_slot), zero, zero,
                            flat(u.exit_any), flat(u.entry_any))
        traversals = T.upsert(traversals, flat(u.key_hi), flat(u.key_lo),
                              (cov8,), flat(u.exit_any | u.entry_any),
                              modes=("add",), shard_bits=cfg.shard_bits)
    return ScanResult(
        junctions=junctions, sinks=sinks, n_solid=u.n_solid,
        n_junc_pos=u.n_junc_pos, jm=u.jm, canon_hi=u.canon_hi,
        canon_lo=u.canon_lo, jspool=jspool, traversals=traversals)


def make_traversals(cfg) -> T.Table:
    """Per-k-mer slot traversal counts for a single-pass stream.

    In a single pass a window is a junction only once filter E knows its
    branch, and a doubled sequencing error makes that branch whenever its
    second copy arrives — often late in the stream, after most of the
    junction's traversals went by unrecorded. Counting the traversals of
    every solid window (a table sized like the exact solid-k-mer table)
    lets junction_coverage give each junction the counts a two-pass scan
    records."""
    return T.make(cfg.cascade_cap_b, (((8,), jnp.int32),))


def junction_coverage(junctions: T.Table, traversals: T.Table, cfg
                      ) -> T.Table:
    """Replace each junction's slot coverage with its stream-long count."""
    found, idx = T.lookup(traversals, junctions.keys_hi, junctions.keys_lo,
                          T.occupied_mask(junctions),
                          shard_bits=cfg.shard_bits)
    cov8 = jnp.where(found[:, None], traversals.vals[0][idx],
                     junctions.vals[0])
    return junctions._replace(vals=(cov8,) + tuple(junctions.vals[1:]))


def scan_core(solid_fn, bases, lens, cfg, node_solid_fn=None,
              window_solid=None) -> ScanUpdates:
    """Scan with injected oracles — the same code path serves the local
    pipeline and the hash-range-sharded one (where the oracles route
    queries to owner shards, dist/sharded.py).

    solid_fn answers k-mer membership in solid filter B. node_solid_fn
    (junction_detect == "nodes") answers tagged branch-node membership in
    node filter E (core/nodes.py) — junction detection then costs 2
    probes/window instead of the reference-style 8-way extension probe
    (SURVEY.md §3.2; provably the same junction set in exact mode,
    tests/unit/test_nodes.py).

    For k > 31 the per-window keys are 62-bit fingerprints of 4-word wide
    codes (core/wide.py); everything downstream of (key, slot, mask) is
    width-agnostic."""
    k = cfg.size_kmer
    if k <= 31:
        view = KM.kmerize(bases, lens, k)
        key_hi, key_lo = view.canon_hi, view.canon_lo
        cisf, valid = view.canon_is_fwd, view.valid
        other_hi, other_lo = u2.select(cisf, view.rc_hi, view.rc_lo,
                                       view.fwd_hi, view.fwd_lo)
        words = None

        def ext_keys():
            return KM.slot_ext_pairs(key_hi, key_lo, other_hi, other_lo,
                                     k)
    else:
        from faucet_tpu.core import wide as W

        wv = W.kmerize_wide(bases, lens, k)
        key_hi, key_lo = wv.key_hi, wv.key_lo
        cisf, valid = wv.canon_is_fwd, wv.valid
        other = W.wselect(cisf, wv.rc, wv.fwd)
        words = jnp.stack(wv.canon, axis=-1)  # [B, P, 4]

        def ext_keys():
            return W.slot_ext_keys_wide(wv.canon, other, k)

    B, P = key_hi.shape
    solid = (window_solid & valid) if window_solid is not None \
        else solid_fn(key_hi, key_lo, valid)

    # neighbor read bases (codes) just outside each window
    nb = jnp.pad(bases[:, k:], ((0, 0), (0, max(0, P - (bases.shape[1] - k)))),
                 constant_values=4)[:, :P]
    pb = jnp.pad(bases[:, : P - 1], ((0, 0), (1, 0)), constant_values=4)
    ex_slot = exit_slot(cisf, jnp.minimum(nb, 3).astype(I32))
    en_slot = entry_slot(cisf, jnp.minimum(pb, 3).astype(I32))

    if node_solid_fn is not None and cfg.use_node_junctions:
        from faucet_tpu.core import nodes as ND

        rk_hi, rk_lo, lk_hi, lk_lo = ND.probe_keys(
            key_hi, key_lo, other_hi, other_lo, cfg.size_kmer)
        # one probe call for both branch queries: one kernel launch
        # locally, one routing round when sharded
        qhi = jnp.stack([rk_hi, lk_hi])
        qlo = jnp.stack([rk_lo, lk_lo])
        branch = node_solid_fn(qhi, qlo,
                               jnp.broadcast_to(solid, qhi.shape))
        is_junc = solid & (branch[0] | branch[1])
    else:
        # The read itself answers 2 of the 8 extension probes: the slot
        # the read exits a window by IS the next window's k-mer (same
        # canonical key -> same membership bit), and the entry slot is
        # the previous window's. Mask those lanes off the probe and fill
        # from the neighboring windows' own solidity — bit-identical to
        # probing, ~25% fewer probe lanes.
        next_solid = jnp.pad(solid[:, 1:], ((0, 0), (0, 1)))
        prev_solid = jnp.pad(solid[:, :-1], ((0, 0), (1, 0)))
        next_valid = jnp.pad(valid[:, 1:], ((0, 0), (0, 1)))
        prev_valid = jnp.pad(valid[:, :-1], ((0, 0), (1, 0)))
        sl8 = jnp.arange(8, dtype=I32)
        ex_oh_b = (ex_slot[..., None] == sl8) \
            & (valid & next_valid)[..., None]
        en_oh_b = (en_slot[..., None] == sl8) \
            & (valid & prev_valid)[..., None]
        known = ex_oh_b | en_oh_b
        fill = ((ex_oh_b & next_solid[..., None]) |
                (en_oh_b & prev_solid[..., None])) & solid[..., None]

        ehi, elo = ext_keys()
        probed = solid_fn(
            ehi, elo,
            jnp.broadcast_to(solid[..., None], ehi.shape) & ~known)
        ext_solid = jnp.where(known, fill, probed)
        right_deg = jnp.sum(ext_solid[..., 0:4], axis=-1)
        left_deg = jnp.sum(ext_solid[..., 4:8], axis=-1)
        is_junc = solid & ((right_deg >= 2) | (left_deg >= 2))

    rs, re, pj, nj, tot, start_m, end_m = _row_runs(solid, is_junc)
    pos = jnp.arange(P, dtype=I32)[None, :]

    exit_any = solid & ~end_m
    entry_any = solid & ~start_m
    exit_ok = is_junc & exit_any
    entry_ok = is_junc & entry_any
    ex_dist = (jnp.where(nj >= 0, nj, re) - pos).astype(I32)
    en_dist = (pos - jnp.where(pj >= 0, pj, rs)).astype(I32)

    # EVERY maximal-solid-run end is a sink/cap anchor — including ends
    # inside junction-containing reads (SURVEY.md §3.2 mid-path caps,
    # §A.4): caps record how deep real coverage reaches along each path;
    # pass-1 walks trim Bloom-FP tails back to the deepest cap
    sink_pos = solid & (start_m | end_m)
    sink_cov = (start_m.astype(I32) + end_m.astype(I32))

    wgrid = (words if words is not None
             else jnp.zeros((B, P, 0), jnp.uint32))
    return ScanUpdates(
        is_junc=is_junc, ex_slot=ex_slot.astype(I32),
        en_slot=en_slot.astype(I32), ex_dist=ex_dist, en_dist=en_dist,
        exit_ok=exit_ok, entry_ok=entry_ok,
        exit_any=exit_any, entry_any=entry_any,
        sink_pos=sink_pos, sink_cov=sink_cov,
        key_hi=key_hi, key_lo=key_lo, words=wgrid,
        jm=is_junc, canon_hi=key_hi, canon_lo=key_lo,
        n_solid=jnp.sum(solid, dtype=I32),
        n_junc_pos=jnp.sum(is_junc, dtype=I32))


J_CHUNK = 32  # junction lanes per pair-capture round (NOT a cap: rounds
#   iterate until every distinct junction of every mate is covered —
#   VERDICT r2 weak #5 removed the old silent first-32 truncation)


def _row_junctions(jm, chi, clo):
    """ALL distinct junction canon codes per row, compacted to the front.

    Returns (hi, lo, valid, count) with hi/lo/valid [B, P] (valid lanes
    contiguous from column 0) and count [B] distinct junctions per row.
    """
    B, P = jm.shape
    hi_m = jnp.where(jm, chi, np.uint32(0xFFFFFFFF))
    lo_m = jnp.where(jm, clo, np.uint32(0xFFFFFFFF))
    shi, slo = jax.lax.sort((hi_m, lo_m), num_keys=2, dimension=1)
    first = jnp.concatenate(
        [jnp.ones((B, 1), bool),
         (shi[:, 1:] != shi[:, :-1]) | (slo[:, 1:] != slo[:, :-1])], axis=1)
    valid = first & (shi != np.uint32(0xFFFFFFFF))
    # compact distinct lanes to the front so capture rounds are bounded
    # by the true per-row counts, not by P
    order = jnp.argsort(~valid, axis=1, stable=True)
    hi = jnp.take_along_axis(shi, order, axis=1)
    lo = jnp.take_along_axis(slo, order, axis=1)
    v = jnp.take_along_axis(valid, order, axis=1)
    return hi, lo, v, jnp.sum(valid, axis=1, dtype=I32)


def capture_pairs(pairs: T.Table, res1: ScanResult, res2: ScanResult,
                  cfg=None) -> T.Table:
    """Record junction co-occurrences across mate pairs (SURVEY.md §3.4).

    res1/res2 are the ScanResults of the two mate batches (row-aligned).
    Cross product of each row's distinct junction sets, keyed by the
    order-independent pair hash, counted in the pair table. LOSSLESS:
    J_CHUNK x J_CHUNK tiles of the cross product run under a fori_loop
    whose trip count follows the batch's densest mate, so one tile pair
    (the common case) costs what the old capped version did while
    junction-dense mates (repeats — exactly where pairs matter) just
    take more rounds."""
    from faucet_tpu.core.hashing import pair_key

    ahi, alo, av, na = _row_junctions(res1.jm, res1.canon_hi,
                                      res1.canon_lo)
    bhi, blo, bv, nb = _row_junctions(res2.jm, res2.canon_hi,
                                      res2.canon_lo)
    J = J_CHUNK
    B = ahi.shape[0]

    def padJ(x, fill):
        padn = (-x.shape[1]) % J
        if not padn:
            return x
        return jnp.pad(x, ((0, 0), (0, padn)),
                       constant_values=x.dtype.type(fill))

    ahi, alo, av = padJ(ahi, 0xFFFFFFFF), padJ(alo, 0xFFFFFFFF), \
        padJ(av, False)
    bhi, blo, bv = padJ(bhi, 0xFFFFFFFF), padJ(blo, 0xFFFFFFFF), \
        padJ(bv, False)
    ra = (jnp.max(na) + (J - 1)) // J   # dynamic tile counts
    rb = (jnp.max(nb) + (J - 1)) // J
    shard_bits = 0 if cfg is None else cfg.shard_bits

    def tile(i, tbl):
        ta, tb = i // jnp.maximum(rb, 1), i % jnp.maximum(rb, 1)
        sl = lambda x, t: jax.lax.dynamic_slice(x, (0, t * J), (B, J))
        khi, klo = pair_key(sl(ahi, ta)[:, :, None],
                            sl(alo, ta)[:, :, None],
                            sl(bhi, tb)[:, None, :],
                            sl(blo, tb)[:, None, :])
        mask = sl(av, ta)[:, :, None] & sl(bv, tb)[:, None, :]
        n = khi.size
        return T.upsert(tbl, khi.reshape(n), klo.reshape(n),
                        (jnp.ones((n,), I32),), mask.reshape(n),
                        modes=("add",), shard_bits=shard_bits)

    return jax.lax.fori_loop(0, ra * rb, tile, pairs)


def load_batch(cascade: BL.Cascade, bases, lens, cfg) -> BL.Cascade:
    """Phase-1 cascade load of every valid window of the batch."""
    return load_batch_s(cascade, bases, lens, cfg)[0]


def load_batch_s(cascade: BL.Cascade, bases, lens, cfg):
    """load_batch + the per-window solidity grid (see load_batch_nodes_s)."""
    if cfg.size_kmer <= 31:
        view = KM.kmerize(bases, lens, cfg.size_kmer)
        khi, klo, valid = view.canon_hi, view.canon_lo, view.valid
    else:
        from faucet_tpu.core import wide as W

        wv = W.kmerize_wide(bases, lens, cfg.size_kmer)
        khi, klo, valid = wv.key_hi, wv.key_lo, wv.valid
    cascade, _new_b, solid = BL.cascade_insert_nbs(
        cascade, khi.reshape(-1), klo.reshape(-1), valid.reshape(-1), cfg)
    return cascade, solid.reshape(khi.shape)


def load_batch_nodes(cascade: BL.Cascade, node_cascade: BL.Cascade,
                     bases, lens, cfg):
    """Phase-1 load + branch-node cascade maintenance (junction_detect
    "nodes"): each k-mer newly promoted into solid filter B contributes
    its two tagged endpoint keys to the D->E node cascade
    (core/nodes.py). Returns (cascade, node_cascade, n_new_b) where
    n_new_b counts this batch's first-promotions into B (drives the
    measured probes/s metric and the new_solid counter)."""
    cascade, node_cascade, n_new, _ = load_batch_nodes_s(
        cascade, node_cascade, bases, lens, cfg)
    return cascade, node_cascade, n_new


def load_batch_nodes_s(cascade: BL.Cascade, node_cascade: BL.Cascade,
                       bases, lens, cfg):
    """load_batch_nodes + the per-window B-solidity grid the insert pass
    computes anyway (bit1 of the fused kernel's flags): single-pass
    streaming hands it to scan_core so the scan skips its own window
    probe — one probe lane per window saved (VERDICT r2 #1c)."""
    from faucet_tpu.core import nodes as ND

    view = KM.kmerize(bases, lens, cfg.size_kmer)
    khi = view.canon_hi.reshape(-1)
    klo = view.canon_lo.reshape(-1)
    valid = view.valid.reshape(-1)
    cascade, new_b, solid = BL.cascade_insert_nbs(cascade, khi, klo,
                                                  valid, cfg)
    other_hi, other_lo = u2.select(view.canon_is_fwd, view.rc_hi,
                                   view.rc_lo, view.fwd_hi, view.fwd_lo)
    pk_hi, pk_lo, sk_hi, sk_lo = ND.endpoint_keys(
        view.canon_hi, view.canon_lo, other_hi, other_lo, cfg.size_kmer)
    nhi = jnp.concatenate([pk_hi.reshape(-1), sk_hi.reshape(-1)])
    nlo = jnp.concatenate([pk_lo.reshape(-1), sk_lo.reshape(-1)])
    nmask = jnp.concatenate([new_b, new_b])
    node_cascade = BL.cascade_insert(node_cascade, nhi, nlo, nmask,
                                     cfg.node_view())
    return (cascade, node_cascade, jnp.sum(new_b, dtype=I32),
            solid.reshape(view.canon_hi.shape))
