"""Hash-range-sharded stream phases (shard_map over a 1-D device mesh).

The north-star distributed design (SURVEY.md §2.2, §7.1.3): the Bloom
cascade and junction/sink tables are partitioned by the top bits of each
k-mer's h1 hash. Because single-device addressing is already owner-
prefixed (core/bloom._positions, core/table._probe_idx), the global
arrays split along axis 0 into exactly the per-shard local structures —
`shard_map` with PartitionSpec("shard") hands every device its own
hash-range slice, and the stream phases differ from the local ones only
in routing:

  load:  kmerize local rows -> all_to_all k-mers to owner -> local
         cascade insert
  scan:  solidity probes route to owner and answers route back
         (dist/route.py round trip); junction/sink updates route to owner
         and upsert locally

Each host feeds its own batch rows (data-parallel input); the graph-build
phase runs on the global arrays directly — they ARE the single-device
layout — so GraphBuilder needs no sharded variant.

Table counters are carried as shape-[n_shards] arrays (one lane per
shard) so they live under the same PartitionSpec as the keyed arrays.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from faucet_tpu.core import bloom as BL
from faucet_tpu.core import kmer as KM
from faucet_tpu.core import scan as SC
from faucet_tpu.core import table as T
from faucet_tpu.core.hashing import hash_pair
from faucet_tpu.dist import route as R
from faucet_tpu.dist.mesh import AXIS, fetch

I32 = jnp.int32


def _owner(khi, klo, shard_bits: int):
    h1, _ = hash_pair(khi, klo)
    return (h1 >> np.uint32(32 - shard_bits)).astype(I32)


def _cap_for(n: int, n_shards: int, factor: float = 2.0) -> int:
    """Static per-peer bucket capacity for n items over n_shards."""
    base = -(-n // n_shards)
    return max(64, int(base * factor))


def vec_counters(tbl: T.Table, n_shards: int) -> T.Table:
    """Scalar counters -> one lane per shard."""
    return tbl._replace(
        count=jnp.zeros((n_shards,), jnp.int32),
        dropped=jnp.zeros((n_shards,), jnp.int32))


def _load_local(cascade: BL.Cascade, bases, lens, *, cfg_local, n_shards,
                shard_bits):
    k = cfg_local.size_kmer
    if k <= 31:
        view = KM.kmerize(bases, lens, k)
        khi = view.canon_hi.reshape(-1)
        klo = view.canon_lo.reshape(-1)
        mask = view.valid.reshape(-1)
    else:
        from faucet_tpu.core import wide as WD

        wv = WD.kmerize_wide(bases, lens, k)
        khi = wv.key_hi.reshape(-1)
        klo = wv.key_lo.reshape(-1)
        mask = wv.valid.reshape(-1)
    owner = _owner(khi, klo, shard_bits)
    cap = _cap_for(khi.shape[0], n_shards)
    cascade, unsent = R.route_consume(
        {"hi": khi, "lo": klo}, owner, mask, n_shards, cap,
        lambda c, recv, rmask: BL.cascade_insert(
            c, recv["hi"], recv["lo"], rmask, cfg_local),
        cascade)
    return cascade, unsent.reshape(1)


def _load_local_nodes(cascade: BL.Cascade, node_cascade: BL.Cascade,
                      bases, lens, *, cfg_local, n_shards, shard_bits):
    """Load + branch-node cascade, sharded: k-mers route to their owner
    (endpoint keys ride along as payload), the owner's insert reports
    new-B promotions, and the promoted endpoint keys route onward to
    THEIR owners for the D->E insert (SURVEY.md §2.2 collectives row)."""
    from faucet_tpu.core import nodes as ND
    from faucet_tpu.core import u32x2 as u2

    k = cfg_local.size_kmer
    view = KM.kmerize(bases, lens, k)
    khi = view.canon_hi.reshape(-1)
    klo = view.canon_lo.reshape(-1)
    mask = view.valid.reshape(-1)
    other_hi, other_lo = u2.select(view.canon_is_fwd, view.rc_hi,
                                   view.rc_lo, view.fwd_hi, view.fwd_lo)
    pk_hi, pk_lo, sk_hi, sk_lo = ND.endpoint_keys(
        view.canon_hi, view.canon_lo, other_hi, other_lo, k)
    owner = _owner(khi, klo, shard_bits)
    cap = _cap_for(khi.shape[0], n_shards)
    ncfg = cfg_local.node_view()

    def consume(state, recv, rmask):
        cascade, node_cascade, unsent_inner = state
        cascade, new_b = BL.cascade_insert_nb(
            cascade, recv["hi"], recv["lo"], rmask, cfg_local)
        # promoted endpoint keys route onward to THEIR owners (nested
        # lossless round loop; inner trip count is pmax'd too)
        nhi = jnp.concatenate([recv["pk_hi"], recv["sk_hi"]])
        nlo = jnp.concatenate([recv["pk_lo"], recv["sk_lo"]])
        nmask = jnp.concatenate([new_b & rmask, new_b & rmask])
        nowner = _owner(nhi, nlo, shard_bits)
        ncap = _cap_for(nhi.shape[0], n_shards)
        node_cascade, un = R.route_consume(
            {"hi": nhi, "lo": nlo}, nowner, nmask, n_shards, ncap,
            lambda nc, nrecv, nrmask: BL.cascade_insert(
                nc, nrecv["hi"], nrecv["lo"], nrmask, ncfg),
            node_cascade)
        return cascade, node_cascade, unsent_inner + un

    (cascade, node_cascade, un_inner), unsent = R.route_consume(
        {"hi": khi, "lo": klo,
         "pk_hi": pk_hi.reshape(-1), "pk_lo": pk_lo.reshape(-1),
         "sk_hi": sk_hi.reshape(-1), "sk_lo": sk_lo.reshape(-1)},
        owner, mask, n_shards, cap, consume,
        (cascade, node_cascade, jnp.zeros((), I32)))
    return cascade, node_cascade, (unsent + un_inner).reshape(1)


def _routed_solid_fn(cascade, cfg_local, n_shards, shard_bits, drops):
    def solid_fn(khi, klo, mask):
        shape = khi.shape
        fhi = khi.reshape(-1)
        flo = klo.reshape(-1)
        fm = jnp.asarray(mask).reshape(-1)
        owner = _owner(fhi, flo, shard_bits)
        cap = _cap_for(fhi.shape[0], n_shards)
        got, unsent = R.route_query(
            {"hi": fhi, "lo": flo}, owner, fm, n_shards, cap,
            lambda recv, rmask: BL.cascade_solid(
                cascade, recv["hi"], recv["lo"], rmask, cfg_local))
        drops.append(unsent)
        return (got > 0).reshape(shape)

    return solid_fn


def _routed_node_fn(node_cascade, cfg_local, n_shards, shard_bits, drops):
    ncfg = cfg_local.node_view()

    def node_fn(khi, klo, mask):
        shape = khi.shape
        fhi = khi.reshape(-1)
        flo = klo.reshape(-1)
        fm = jnp.asarray(mask).reshape(-1)
        owner = _owner(fhi, flo, shard_bits)
        cap = _cap_for(fhi.shape[0], n_shards)
        got, unsent = R.route_query(
            {"hi": fhi, "lo": flo}, owner, fm, n_shards, cap,
            lambda recv, rmask: BL.cascade_solid(
                node_cascade, recv["hi"], recv["lo"], rmask, ncfg))
        drops.append(unsent)
        return (got > 0).reshape(shape)

    return node_fn


def _scan_local(cascade: BL.Cascade, junctions: T.Table, sinks: T.Table,
                bases, lens, node_cascade: BL.Cascade = None,
                traversals: T.Table = None, *, cfg, cfg_local, n_shards,
                shard_bits):
    drops = []
    solid_fn = _routed_solid_fn(cascade, cfg_local, n_shards, shard_bits,
                                drops)
    node_fn = None
    if node_cascade is not None and cfg.use_node_junctions:
        node_fn = _routed_node_fn(node_cascade, cfg_local, n_shards,
                                  shard_bits, drops)
    u = SC.scan_core(solid_fn, bases, lens, cfg, node_solid_fn=node_fn)

    # junction/sink updates: compaction rounds (lossless, like the local
    # path) with per-round owner routing at full-size per-peer buckets,
    # so routing can never drop what a round carries; the round count is
    # pmax'd over the mesh so every shard issues the same collectives
    B, P = u.is_junc.shape
    flat = lambda a: a.reshape((B * P,) + a.shape[2:])
    K = min(B * P, cfg.scan_update_cap)
    wide = cfg.size_kmer > 31
    sync = lambda r: jax.lax.pmax(r, AXIS)

    def jfn(st, cm, ps):
        tbl, dr = st
        jhi, jlo, exs, ens, exd, end_, exo, eno, words = ps
        # route the SLIM slot/dist/flag fields (slots+flags packed into
        # one u32, dists into another: 8 B/lane instead of the 48 B/lane
        # dense cov8+dist8 rows) and expand to one-hot update rows at
        # the OWNER shard right before the upsert (VERDICT r3 #2)
        packed = (exs.astype(jnp.uint32)
                  | (ens.astype(jnp.uint32) << 3)
                  | (exo.astype(jnp.uint32) << 6)
                  | (eno.astype(jnp.uint32) << 7))
        dists = (exd.astype(jnp.uint32) & 0xFFFF) \
            | ((end_.astype(jnp.uint32) & 0xFFFF) << 16)
        jp = {"hi": jhi, "lo": jlo, "sf": packed, "dd": dists}
        if wide:
            jp["words"] = words

        def consume(t, recv, rmask):
            sf, dd = recv["sf"], recv["dd"]
            cov8, dist8 = SC.cov_dist8(
                (sf & 7).astype(I32), ((sf >> 3) & 7).astype(I32),
                (dd & 0xFFFF).astype(I32), (dd >> 16).astype(I32),
                (sf >> 6) & 1 > 0, (sf >> 7) & 1 > 0)
            return T.upsert(
                t, recv["hi"], recv["lo"],
                (cov8, dist8) + ((recv["words"],) if wide else ()),
                rmask, modes=("add", "max") + (("max",) if wide else ()))

        tbl, un = R.route_consume(
            jp, _owner(jhi, jlo, shard_bits), cm, n_shards, K,
            consume, tbl)
        return tbl, dr + un

    (junctions, jdrop), _ = SC.upsert_rounds(
        flat(u.is_junc), K,
        (flat(u.key_hi), flat(u.key_lo), flat(u.ex_slot),
         flat(u.en_slot), flat(u.ex_dist), flat(u.en_dist),
         flat(u.exit_ok), flat(u.entry_ok), flat(u.words)),
        jfn, (junctions, jnp.zeros((), I32)), sync=sync)

    def sfn(st, cm, ps):
        tbl, dr = st
        shi, slo, scov, words = ps
        sp = {"hi": shi, "lo": slo, "cov": scov}
        if wide:
            sp["words"] = words
        tbl, un = R.route_consume(
            sp, _owner(shi, slo, shard_bits), cm, n_shards, K,
            lambda t, recv, rmask: T.upsert(
                t, recv["hi"], recv["lo"],
                (recv["cov"],) + ((recv["words"],) if wide else ()),
                rmask, modes=("add",) + (("max",) if wide else ())),
            tbl)
        return tbl, dr + un

    (sinks, sdrop), _ = SC.upsert_rounds(
        flat(u.sink_pos), K,
        (flat(u.key_hi), flat(u.key_lo), flat(u.sink_cov),
         flat(u.words)), sfn, (sinks, jnp.zeros((), I32)), sync=sync)

    tdrop = jnp.zeros((), I32)
    if traversals is not None:
        # single-pass streams: every solid window's slot traversals
        # (core/scan.make_traversals), slots+flags packed as for jfn
        def tfn(st, cm, ps):
            tbl, dr = st
            thi, tlo, exs, ens, exo, eno = ps
            packed = (exs.astype(jnp.uint32)
                      | (ens.astype(jnp.uint32) << 3)
                      | (exo.astype(jnp.uint32) << 6)
                      | (eno.astype(jnp.uint32) << 7))

            def consume(t, recv, rmask):
                sf = recv["sf"]
                zero = jnp.zeros(sf.shape, I32)
                cov8, _ = SC.cov_dist8(
                    (sf & 7).astype(I32), ((sf >> 3) & 7).astype(I32),
                    zero, zero, (sf >> 6) & 1 > 0, (sf >> 7) & 1 > 0)
                return T.upsert(t, recv["hi"], recv["lo"], (cov8,), rmask,
                                modes=("add",))

            tbl, un = R.route_consume(
                {"hi": thi, "lo": tlo, "sf": packed},
                _owner(thi, tlo, shard_bits), cm, n_shards, K, consume,
                tbl)
            return tbl, dr + un

        (traversals, tdrop), _ = SC.upsert_rounds(
            flat(u.exit_any | u.entry_any), K,
            (flat(u.key_hi), flat(u.key_lo), flat(u.ex_slot),
             flat(u.en_slot), flat(u.exit_any), flat(u.entry_any)),
            tfn, (traversals, tdrop), sync=sync)

    total_drops = (sum(drops) + jdrop + sdrop + tdrop).reshape(1)
    return (junctions, sinks, u.n_solid.reshape(1),
            u.n_junc_pos.reshape(1), u.jm, u.canon_hi, u.canon_lo,
            total_drops, traversals)


def _pairs_local(pairs: T.Table, jm1, chi1, clo1, jm2, chi2, clo2, *,
                 n_shards, shard_bits):
    """Paired-end junction pair capture, sharded (SURVEY.md §3.4;
    VERDICT r1 #5): each shard's mate rows contribute cross-product pair
    keys, routed LOSSLESSLY to the pair-hash owner shard and counted in
    its local pair-table slice."""
    from faucet_tpu.core.hashing import pair_key

    ahi, alo, av, na = SC._row_junctions(jm1, chi1, clo1)
    bhi, blo, bv, nb = SC._row_junctions(jm2, chi2, clo2)
    J = SC.J_CHUNK
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
    # every shard must run the same (lossless) tile count: pmax over the
    # mesh axis so the collectives inside route_consume stay congruent
    ra = jax.lax.pmax((jnp.max(na) + (J - 1)) // J, "shard")
    rb = jax.lax.pmax((jnp.max(nb) + (J - 1)) // J, "shard")
    cap = _cap_for(B * J * J, n_shards)

    def tile(i, carry):
        pairs, unsent = carry
        ta, tb = i // jnp.maximum(rb, 1), i % jnp.maximum(rb, 1)
        sl = lambda x, t: jax.lax.dynamic_slice(x, (0, t * J), (B, J))
        khi, klo = pair_key(sl(ahi, ta)[:, :, None],
                            sl(alo, ta)[:, :, None],
                            sl(bhi, tb)[:, None, :],
                            sl(blo, tb)[:, None, :])
        mask = (sl(av, ta)[:, :, None] & sl(bv, tb)[:, None, :]) \
            .reshape(-1)
        khi = khi.reshape(-1)
        klo = klo.reshape(-1)
        owner = _owner(khi, klo, shard_bits)
        pairs, u = R.route_consume(
            {"hi": khi, "lo": klo}, owner, mask, n_shards, cap,
            lambda t, recv, rmask: T.upsert(
                t, recv["hi"], recv["lo"],
                (jnp.ones(rmask.shape, I32),), rmask, modes=("add",)),
            pairs)
        return pairs, unsent + u

    pairs, unsent = jax.lax.fori_loop(
        0, ra * rb, tile, (pairs, jnp.zeros((), I32)))
    return pairs, unsent.reshape(1)


class ShardedStream:
    """Jitted shard_map wrappers around the stream phases."""

    def __init__(self, cfg, mesh):
        assert cfg.n_shards == mesh.shape[AXIS]
        self.cfg = cfg
        self.mesh = mesh
        self.cfg_local = cfg.local_shard()
        S = cfg.n_shards
        sb = cfg.shard_bits

        state_spec = P(AXIS)
        rows = P(AXIS)
        rep = P(AXIS)  # per-shard scalar lanes
        self.use_nodes = cfg.use_node_junctions

        # buffer donation mirrors pipeline.Pipeline's (the callers
        # always replace their state references with the returned
        # tables): without it every batch copies the table-capacity
        # arrays — the copy grows with the genome-sized capacities
        # while batch count grows with reads
        if self.use_nodes:
            self._load = jax.jit(shard_map(
                partial(_load_local_nodes, cfg_local=self.cfg_local,
                        n_shards=S, shard_bits=sb),
                mesh=mesh,
                in_specs=(state_spec, state_spec, rows, rows),
                out_specs=(state_spec, state_spec, rep),
                check_vma=False), donate_argnums=(0, 1))
        else:
            self._load = jax.jit(shard_map(
                partial(_load_local, cfg_local=self.cfg_local, n_shards=S,
                        shard_bits=sb),
                mesh=mesh,
                in_specs=(state_spec, rows, rows),
                out_specs=(state_spec, rep),
                check_vma=False), donate_argnums=(0,))
        # node_cascade and traversals may each be None (an empty pytree)
        self._scan = jax.jit(shard_map(
            partial(_scan_local, cfg=cfg, cfg_local=self.cfg_local,
                    n_shards=S, shard_bits=sb),
            mesh=mesh,
            in_specs=(state_spec, state_spec, state_spec, rows, rows,
                      state_spec, state_spec),
            out_specs=(state_spec, state_spec, rep, rep, rows, rows,
                       rows, rep, state_spec),
            check_vma=False), donate_argnums=(1, 2, 6))
        # junction and traversal rows of one key live on the same shard
        self._jcov = jax.jit(shard_map(
            partial(SC.junction_coverage, cfg=self.cfg_local),
            mesh=mesh, in_specs=(state_spec, state_spec),
            out_specs=state_spec, check_vma=False), donate_argnums=(0,))

        self._pairs = jax.jit(shard_map(
            partial(_pairs_local, n_shards=S, shard_bits=sb),
            mesh=mesh,
            in_specs=(state_spec, rows, rows, rows, rows, rows, rows),
            out_specs=(state_spec, rep),
            check_vma=False))

    def pairs(self, pairs_tbl, jm1, chi1, clo1, jm2, chi2, clo2):
        return self._pairs(pairs_tbl, jm1, chi1, clo1, jm2, chi2, clo2)

    def place_state(self, tree):
        """Shard a state pytree's leading axes over the mesh."""
        sh = NamedSharding(self.mesh, P(AXIS))
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sh), tree)

    def shard_batch(self, bases, lens):
        """Place a host batch row-sharded over the mesh.

        Single-process: a plain sharded device_put. Multi-host: each
        process contributes its local rows (data-parallel input,
        SURVEY.md §2.2 DP row) and the global batch is their
        concatenation along axis 0.
        """
        sh = NamedSharding(self.mesh, P(AXIS))
        if jax.process_count() > 1:
            mk = jax.make_array_from_process_local_data
            return (mk(sh, np.asarray(bases)), mk(sh, np.asarray(lens)))
        return (jax.device_put(bases, sh), jax.device_put(lens, sh))

    def load(self, cascade, bases, lens, node_cascade=None):
        bases, lens = self.shard_batch(bases, lens)
        if self.use_nodes:
            return self._load(cascade, node_cascade, bases, lens)
        return self._load(cascade, bases, lens)

    def scan(self, cascade, junctions, sinks, bases, lens,
             node_cascade=None, traversals=None):
        bases, lens = self.shard_batch(bases, lens)
        return self._scan(cascade, junctions, sinks, bases, lens,
                          node_cascade if self.use_nodes else None,
                          traversals)


class ShardedPipeline:
    """Multi-device pipeline: sharded stream phases + the unchanged host
    build/clean/emit phases operating on the global arrays.

    Mirrors faucet_tpu.pipeline.Pipeline's surface (load_reads,
    scan_reads, build, clean_graph, run_file_mode).
    """

    def __init__(self, cfg, mesh, metrics=None):
        from faucet_tpu.metrics import Metrics

        self.cfg = cfg
        self.mesh = mesh
        self.metrics = metrics or Metrics(cfg.metrics_file)
        S = cfg.n_shards
        # multi-host: each process feeds batch_reads/process_count rows
        nproc = jax.process_count()
        self.feed_cfg = dataclasses.replace(
            cfg, batch_reads=max(1, cfg.batch_reads // nproc)) \
            if nproc > 1 else cfg
        self.stream = ShardedStream(cfg, mesh)
        self.cascade = self.stream.place_state(
            _vec_cascade(BL.make_cascade(cfg), S))
        self.node_cascade = None
        if cfg.use_node_junctions:
            self.node_cascade = self.stream.place_state(
                _vec_cascade(BL.make_cascade(cfg.node_view()), S))
        wspec = (((4,), jnp.uint32),) if cfg.wide else ()
        self.junctions = self.stream.place_state(vec_counters(
            T.make(cfg.junction_cap,
                   (((8,), jnp.int32), ((8,), jnp.uint16)) + wspec), S))
        self.sinks = self.stream.place_state(vec_counters(
            T.make(cfg.sink_cap, (((), jnp.int32),) + wspec), S))
        self.pairs = self.stream.place_state(vec_counters(
            T.make(cfg.pair_cap, (((), jnp.int32),)), S))
        self.traversals = None  # single-pass streams (Pipeline's twin)

    def _start_stream(self):
        if self.traversals is None:
            self.traversals = self.stream.place_state(vec_counters(
                SC.make_traversals(self.cfg), self.cfg.n_shards))

    # ---- stream phases --------------------------------------------------
    def load_reads(self, reads):
        from faucet_tpu.pipeline import batch_iter

        m = self.metrics
        m.start("load")
        for bases, lens in batch_iter(reads, self.feed_cfg):
            self.load_batch(bases, lens)
        jax.block_until_ready(self.cascade)
        m.stop("load")

    def load_batches(self, batches):
        m = self.metrics
        m.start("load")
        for bases, lens in batches:
            self.load_batch(bases, lens)
        jax.block_until_ready(self.cascade)
        m.stop("load")

    def scan_batches(self, batches):
        m = self.metrics
        m.start("scan")
        for bases, lens in batches:
            self.scan_batch(bases, lens)
        jax.block_until_ready(self.junctions)
        m.stop("scan")

    def run_streaming(self, reads):
        from faucet_tpu.pipeline import batch_iter

        m = self.metrics
        m.start("stream")
        self._start_stream()
        if self.cfg.paired_ends:
            from faucet_tpu.core.kmer import pack_reads
            from faucet_tpu.io.fastq import deinterleave

            cfgf = self.feed_cfg
            m1, m2 = [], []

            def flush(m1, m2):
                pad = cfgf.batch_reads - len(m1)
                b1, l1 = pack_reads(m1 + [""] * pad, cfgf.max_read_length)
                b2, l2 = pack_reads(m2 + [""] * pad, cfgf.max_read_length)
                self.load_batch(b1, l1)
                self.load_batch(b2, l2)
                self._scan_pair_batch(m1, m2)

            for a, b in deinterleave(iter(reads)):
                m1.append(a)
                m2.append(b)
                if len(m1) == cfgf.batch_reads:
                    flush(m1, m2)
                    m1, m2 = [], []
            if m1:
                flush(m1, m2)
        else:
            for bases, lens in batch_iter(reads, self.feed_cfg):
                self.load_batch(bases, lens)
                self.scan_batch(bases, lens)
        jax.block_until_ready(self.junctions)
        m.stop("stream")
        g = self.build()
        g = self.clean_graph(g)
        self.metrics.add("contigs", len(g.live()))
        self.metrics.emit("assembly_done", stats=g.stats())
        return g

    def load_batch(self, bases, lens):
        if self.node_cascade is not None:
            self.cascade, self.node_cascade, drops = self.stream.load(
                self.cascade, jnp.asarray(bases), jnp.asarray(lens),
                self.node_cascade)
        else:
            self.cascade, drops = self.stream.load(self.cascade,
                                                   jnp.asarray(bases),
                                                   jnp.asarray(lens))
        self.metrics.add("reads_loaded", int((np.asarray(lens) > 0).sum()))
        self.metrics.add("route_dropped", int(fetch(drops).sum()))

    def scan_reads(self, reads):
        from faucet_tpu.pipeline import batch_iter

        m = self.metrics
        m.start("scan")
        for bases, lens in batch_iter(reads, self.cfg):
            self.scan_batch(bases, lens)
        jax.block_until_ready(self.junctions)
        m.stop("scan")

    def scan_batch(self, bases, lens):
        (self.junctions, self.sinks, n_solid, n_junc, jm, chi, clo,
         drops, self.traversals) = self.stream.scan(
            self.cascade, self.junctions, self.sinks, jnp.asarray(bases),
            jnp.asarray(lens), self.node_cascade, self.traversals)
        self.metrics.add("reads_scanned", int((np.asarray(lens) > 0).sum()))
        self.metrics.add("solid_windows", int(fetch(n_solid).sum()))
        self.metrics.add("junction_hits", int(fetch(n_junc).sum()))
        self.metrics.add("route_dropped", int(fetch(drops).sum()))
        return jm, chi, clo

    # ---- paired ends (SURVEY.md §3.4; VERDICT r1 #5) ---------------------
    def scan_paired(self, reads):
        """Interleaved mate stream: scans + sharded pair capture."""
        from faucet_tpu.core.kmer import pack_reads
        from faucet_tpu.io.fastq import deinterleave

        m = self.metrics
        m.start("scan")
        cfgf = self.feed_cfg
        m1, m2 = [], []
        for a, b in deinterleave(iter(reads)):
            m1.append(a)
            m2.append(b)
            if len(m1) == cfgf.batch_reads:
                self._scan_pair_batch(m1, m2)
                m1, m2 = [], []
        if m1:
            self._scan_pair_batch(m1, m2)
        jax.block_until_ready(self.junctions)
        m.stop("scan")

    def _scan_pair_batch(self, m1, m2):
        from faucet_tpu.core.kmer import pack_reads

        cfgf = self.feed_cfg
        pad = cfgf.batch_reads - len(m1)
        b1, l1 = pack_reads(m1 + [""] * pad, cfgf.max_read_length)
        b2, l2 = pack_reads(m2 + [""] * pad, cfgf.max_read_length)
        self._scan_pair_packed(b1, l1, b2, l2)

    def _scan_pair_packed(self, b1, l1, b2, l2):
        jm1, chi1, clo1 = self.scan_batch(b1, l1)
        jm2, chi2, clo2 = self.scan_batch(b2, l2)
        self.pairs, unsent = self.stream.pairs(
            self.pairs, jm1, chi1, clo1, jm2, chi2, clo2)
        self.metrics.add("pair_batches", 1)
        self.metrics.add("route_dropped", int(fetch(unsent).sum()))

    def scan_paired_batches(self, batches):
        """Paired scan over PACKED interleaved batches (native C++
        reader path): mates are the alternating rows of each batch."""
        m = self.metrics
        m.start("scan")
        for bases, lens in batches:
            self._scan_pair_packed(bases[0::2], lens[0::2],
                                   bases[1::2], lens[1::2])
        jax.block_until_ready(self.junctions)
        m.stop("scan")

    def run_streaming_batches(self, batches):
        """Single-pass stream over PACKED batches (native reader path);
        paired mates ride the alternating rows."""
        m = self.metrics
        m.start("stream")
        self._start_stream()
        for bases, lens in batches:
            if self.cfg.paired_ends:
                b1, l1 = bases[0::2], lens[0::2]
                b2, l2 = bases[1::2], lens[1::2]
                self.load_batch(b1, l1)
                self.load_batch(b2, l2)
                self._scan_pair_packed(b1, l1, b2, l2)
            else:
                self.load_batch(bases, lens)
                self.scan_batch(bases, lens)
        jax.block_until_ready(self.junctions)
        m.stop("stream")
        g = self.build()
        g = self.clean_graph(g)
        self.metrics.add("contigs", len(g.live()))
        self.metrics.emit("assembly_done", stats=g.stats())
        return g

    def pair_counts(self):
        from faucet_tpu.graph.build import extract_table

        t = extract_table(self.pairs)
        return {(int(h) << 32) | int(l): int(c)
                for h, l, c in zip(t["hi"], t["lo"], t["v0"])}

    def _pair_count_fn(self):
        counts = self.pair_counts()
        if not counts:
            return None
        from faucet_tpu.core.hashing import pair_key_np
        from faucet_tpu.core.kmer import encode_kmer

        def pc(a, b):
            ah, al = encode_kmer(a)
            bh, bl = encode_kmer(b)
            kh, kl = pair_key_np(np.uint32(ah), np.uint32(al),
                                 np.uint32(bh), np.uint32(bl))
            return counts.get((int(kh) << 32) | int(kl), 0)

        return pc

    # ---- host phases (global arrays == single-device layout) ------------
    def build(self):
        from faucet_tpu.graph.build import GraphBuilder

        m = self.metrics
        if self.traversals is not None:
            m.add("traversal_rows", int(fetch(self.traversals.count).sum()))
            self.junctions = self.stream._jcov(self.junctions,
                                               self.traversals)
            self.traversals = None
        if self.cfg.prune_slot_cov > 0:
            self.junctions = prune_slots(self.junctions,
                                         self.cfg.prune_slot_cov)
        m.start("build")
        gb = GraphBuilder(self.cfg, self.cascade, self.junctions,
                          self.sinks, mesh=self.mesh)
        g = gb.build()
        m.stop("build")
        m.add("junctions", int(fetch(self.junctions.count).sum()))
        m.add("sink_anchors", int(fetch(self.sinks.count).sum()))
        m.add("contigs_raw", len(g.live()))
        m.add("walk_route_bytes", gb.route_bytes)
        return g

    def clean_graph(self, g):
        from faucet_tpu.graph.clean import clean

        cfg = self.cfg
        if cfg.no_cleaning:
            return g
        if cfg.distributed_clean:
            # halo-exchange partitioned cleaning (PARITY §config5 item
            # 3): per-shard delete/collapse rounds, boundary updates on
            # the mesh all_to_all; same contig set as clean()
            # (tests/dist/test_halo.py). Paired-end disentangle runs
            # in-protocol too (VERDICT r4 #7): FAR_INFO/DMERGE/
            # CHAIN_HALF tags route pair evidence to the owner shards.
            from faucet_tpu.dist.halo import PartitionedCleaner

            pc = PartitionedCleaner(g, cfg.n_shards, mesh=self.mesh)
            st = pc.clean(
                max_tip_len=int(cfg.tip_len_factor * cfg.max_read_length),
                min_cov=cfg.min_contig_cov,
                pair_count=(self._pair_count_fn()
                            if cfg.paired_ends else None))
            for k, v in st.items():
                self.metrics.add(f"clean_{k}", v)
            return pc.result()
        st = clean(g,
                   max_tip_len=int(cfg.tip_len_factor * cfg.max_read_length),
                   min_cov=cfg.min_contig_cov,
                   pair_count=(self._pair_count_fn()
                               if cfg.paired_ends else None))
        for k, v in st.items():
            self.metrics.add(f"clean_{k}", v)
        return g

    def run_file_mode(self, load_reads, scan_reads):
        self.load_reads(load_reads)
        self.scan_reads(scan_reads)
        g = self.build()
        g = self.clean_graph(g)
        self.metrics.add("contigs", len(g.live()))
        self.metrics.emit("assembly_done", stats=g.stats())
        return g


def _vec_cascade(c: BL.Cascade, n_shards: int) -> BL.Cascade:
    return c._replace(a_table=vec_counters(c.a_table, n_shards),
                      b_table=vec_counters(c.b_table, n_shards))


@jax.jit
def prune_slots(junctions: T.Table, min_slot_cov) -> T.Table:
    """Device pre-clean (first distributed cleaning pass, SURVEY.md §5
    long-context analog / BASELINE config 5): zero junction slots whose
    coverage is below the floor BEFORE walking. Purely elementwise over
    the hash-range-sharded table, so under shard_map/PartitionSpec it is
    a shard-LOCAL pass needing no communication; every pruned slot is a
    contig the host's low-cov delete pass would have removed, but pruned
    here it is never walked or extracted at all."""
    cov8 = junctions.vals[0]
    keep = cov8 >= min_slot_cov
    return junctions._replace(
        vals=(jnp.where(keep, cov8, 0),) + tuple(junctions.vals[1:]))
