"""Pipeline orchestrator: the phase driver of the framework.

Reference analogue: main()'s phase orchestration in ref:src/Faucet.cpp
(SURVEY.md §3.1 [C:med]): load -> scan -> (checkpoint) -> build -> clean
-> emit. Device phases run as jitted batch steps; the compact graph is
extracted to host for cleaning and emission.

Streaming contract: reads are consumed batch-by-batch and never stored by
the pipeline (the caller may hand an iterator); `run_file_mode` makes two
passes over the source like the reference's -read_load_file /
-read_scan_file pair, `run_streaming` makes one pass, inserting then
scanning each batch (the reference's single-pass pipe mode, §3.1 note).
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from faucet_tpu.config import Config
from faucet_tpu.core import bloom as BL
from faucet_tpu.core import scan as SC
from faucet_tpu.core import table as T
from faucet_tpu.core.kmer import pack_reads
from faucet_tpu.graph.build import GraphBuilder
from faucet_tpu.graph.clean import clean
from faucet_tpu.graph.model import ContigGraph
from faucet_tpu.metrics import Metrics


def contig_chunks(g: ContigGraph, max_len: int, k: int) -> List[str]:
    """Chunk first-pass contigs into read-sized windows for a second pass
    at larger k (the dual-k workflow, BASELINE config 2).

    Windows overlap by k-1 so every k-mer of a contig survives chunking;
    each chunk is emitted twice so the cascade marks its k-mers solid.
    """
    out: List[str] = []
    stride = max(1, max_len - (k - 1))
    for i in g.live():
        c = g.contigs[i]
        seq = c.seq + (c.seq[: k - 1] if c.circular else "")
        for start in range(0, max(1, len(seq) - k + 1), stride):
            w = seq[start : start + max_len]
            if len(w) >= k:
                out.append(w)
                out.append(w)
    return out


def batch_iter(reads: Iterable[str], cfg: Config
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Pack a read stream into fixed-shape [batch_reads, max_read_length]
    uint8 batches (the static-shape contract XLA needs)."""
    buf: List[str] = []
    for r in reads:
        buf.append(r)
        if len(buf) == cfg.batch_reads:
            yield pack_reads(buf, cfg.max_read_length)
            buf = []
    if buf:
        buf += [""] * (cfg.batch_reads - len(buf))
        yield pack_reads(buf, cfg.max_read_length)


class Pipeline:
    def __init__(self, cfg: Config, metrics: Optional[Metrics] = None):
        self.cfg = cfg
        self.metrics = metrics or Metrics(cfg.metrics_file)
        self.cascade = BL.make_cascade(cfg)
        # branch-node cascade: junction detection via 2 node probes per
        # window instead of the 8-way extension probe (core/nodes.py)
        self.node_cascade = (BL.make_cascade(cfg.node_view())
                             if cfg.use_node_junctions else None)
        # wide k-mers (k>31) store their 4 canonical code words as table
        # values so walks can seed from fingerprint-keyed entries
        wspec = (((4,), jnp.uint32),) if cfg.wide else ()
        self.junctions = T.make(
            cfg.junction_cap,
            (((8,), jnp.int32), ((8,), jnp.uint16)) + wspec)
        self.sinks = T.make(cfg.sink_cap, (((), jnp.int32),) + wspec)
        self.pairs = T.make(cfg.pair_cap, (((), jnp.int32),))
        self._load = jax.jit(SC.load_batch, static_argnames=("cfg",),
                             donate_argnums=(0,))
        self._load_nodes = jax.jit(SC.load_batch_nodes,
                                   static_argnames=("cfg",),
                                   donate_argnums=(0, 1))
        # single-pass streaming variants: the insert pass also returns
        # the window-solidity grid, and the scan consumes it instead of
        # re-probing B (one probe lane per window saved)
        self._load_s = jax.jit(SC.load_batch_s, static_argnames=("cfg",),
                               donate_argnums=(0,))
        self._load_nodes_s = jax.jit(SC.load_batch_nodes_s,
                                     static_argnames=("cfg",),
                                     donate_argnums=(0, 1))
        # donate the junction/sink tables and the spool: without
        # donation every batch COPIES table-capacity-sized arrays
        # (sinks are sized 4x the k-mer estimate, so the per-batch copy
        # grows with GENOME while batch count grows with READS — the
        # measured scan-phase superlinearity at 2/4/8 Mbp was 30/71/
        # 224 s). The caller always replaces its references with the
        # returned tables (ScanResult), so the old buffers are dead.
        self._scan = jax.jit(SC.scan_batch, static_argnames=("cfg",),
                             donate_argnums=(1, 2),
                             donate_argnames=("jspool", "traversals"))
        self._pairs = jax.jit(SC.capture_pairs,
                      static_argnames=("cfg",),
                      donate_argnums=(0,))
        # cross-batch junction-update spool (single-shard, narrow keys):
        # scan batches append; phase ends flush (core/scan.JSpool)
        self.jspool = (SC.make_jspool(cfg)
                       if cfg.spool_junctions and not cfg.wide else None)
        self._flush = jax.jit(SC.spool_flush, static_argnames=("cfg",),
                              donate_argnums=(0, 1))
        # single-pass streams only: slot traversal counts of every solid
        # k-mer, made at the first stream step (core/scan.make_traversals)
        self.traversals = None
        self._jcov = jax.jit(SC.junction_coverage, static_argnames=("cfg",),
                             donate_argnums=(0,))

    def flush_junctions(self):
        """Drain the junction spool into the table (idempotent; called
        at scan/stream phase ends, so checkpoint save and graph build
        always see the complete table)."""
        if self.jspool is not None and int(self.jspool.cnt) > 0:
            self.junctions, self.jspool = self._flush(
                self.junctions, self.jspool, cfg=self.cfg)

    # ---- phase 1 ---------------------------------------------------------
    def load_reads(self, reads: Iterable[str]):
        self.load_batches(batch_iter(reads, self.cfg))

    def load_batches(self, batches):
        """Phase 1 over an iterator of (bases, lens) packed batches (the
        native C++ reader feeds this directly), prefetched on a reader
        thread with eager device_put (io/stream.py)."""
        from faucet_tpu.io.stream import prefetch_batches

        m = self.metrics
        m.start("load")
        for bases, lens in prefetch_batches(batches):
            self.load_batch(bases, lens)
        jax.block_until_ready(self.cascade)
        m.stop("load")

    def load_batch(self, bases, lens):
        if self.node_cascade is not None:
            # n_new (first promotions) stays on device: fetching a
            # scalar per batch would stall the host on every batch
            self.cascade, self.node_cascade, _n_new = self._load_nodes(
                self.cascade, self.node_cascade, jnp.asarray(bases),
                jnp.asarray(lens), cfg=self.cfg)
        else:
            self.cascade = self._load(self.cascade, jnp.asarray(bases),
                                      jnp.asarray(lens), cfg=self.cfg)
        self.metrics.add("reads_loaded", int((np.asarray(lens) > 0).sum()))

    # ---- phase 2 ---------------------------------------------------------
    def scan_reads(self, reads: Iterable[str]):
        self.scan_batches(batch_iter(reads, self.cfg))

    def scan_batches(self, batches):
        from faucet_tpu.io.stream import prefetch_batches

        m = self.metrics
        m.start("scan")
        for bases, lens in prefetch_batches(batches):
            self.scan_batch(bases, lens)
        self.flush_junctions()
        jax.block_until_ready(self.junctions)
        m.stop("scan")

    def scan_batch(self, bases, lens, window_solid=None):
        res = self._scan(self.cascade, self.junctions, self.sinks,
                         jnp.asarray(bases), jnp.asarray(lens),
                         cfg=self.cfg, node_cascade=self.node_cascade,
                         window_solid=window_solid, jspool=self.jspool,
                         traversals=self.traversals)
        self.junctions = res.junctions
        self.sinks = res.sinks
        if res.jspool is not None:
            self.jspool = res.jspool
        self.traversals = res.traversals
        self.metrics.add("reads_scanned", int((np.asarray(lens) > 0).sum()))
        self.metrics.add("solid_windows", int(res.n_solid))
        self.metrics.add("junction_hits", int(res.n_junc_pos))
        return res

    def stream_step(self, bases, lens):
        """Fused single-pass step: insert the batch, then scan it with
        the window solidity the insert kernel computed in-register
        (bit1 of the fused cascade flags) — the scan's own window probe
        disappears (VERDICT r2 #1c)."""
        self._start_stream()
        bases = jnp.asarray(bases)
        lens_d = jnp.asarray(lens)
        if self.node_cascade is not None:
            (self.cascade, self.node_cascade, _n,
             ws) = self._load_nodes_s(self.cascade, self.node_cascade,
                                      bases, lens_d, cfg=self.cfg)
        else:
            self.cascade, ws = self._load_s(self.cascade, bases, lens_d,
                                            cfg=self.cfg)
        self.metrics.add("reads_loaded", int((np.asarray(lens) > 0).sum()))
        return self.scan_batch(bases, lens, window_solid=ws)

    def _start_stream(self):
        if self.traversals is None:
            self.traversals = SC.make_traversals(self.cfg)

    def scan_paired(self, reads: Iterable[str]):
        """Scan an interleaved mate stream; captures junction pairs for
        disentanglement alongside the normal junction updates."""
        from faucet_tpu.io.fastq import deinterleave

        m = self.metrics
        m.start("scan")
        m1, m2 = [], []
        for a, b in deinterleave(iter(reads)):
            m1.append(a)
            m2.append(b)
            if len(m1) == self.cfg.batch_reads:
                self._scan_pair_batch(m1, m2)
                m1, m2 = [], []
        if m1:
            self._scan_pair_batch(m1, m2)
        self.flush_junctions()
        jax.block_until_ready(self.junctions)
        m.stop("scan")

    def _scan_pair_batch(self, m1: List[str], m2: List[str]):
        pad = self.cfg.batch_reads - len(m1)
        b1, l1 = pack_reads(m1 + [""] * pad, self.cfg.max_read_length)
        b2, l2 = pack_reads(m2 + [""] * pad, self.cfg.max_read_length)
        self._scan_pair_packed(b1, l1, b2, l2)

    def _scan_pair_packed(self, b1, l1, b2, l2):
        r1 = self.scan_batch(b1, l1)
        r2 = self.scan_batch(b2, l2)
        self.pairs = self._pairs(self.pairs, r1, r2, cfg=self.cfg)
        self.metrics.add("pair_batches", 1)

    def scan_paired_batches(self, batches):
        """Paired scan over PACKED interleaved batches (the native C++
        reader feeds this; VERDICT r2 weak #4): mates are alternating
        rows, split even/odd. Row counts must be even (batch_iter and
        the native reader both emit fixed even-size batches)."""
        from faucet_tpu.io.stream import prefetch_batches

        m = self.metrics
        m.start("scan")
        for bases, lens in prefetch_batches(batches):
            self._scan_pair_packed(bases[0::2], lens[0::2],
                                   bases[1::2], lens[1::2])
        self.flush_junctions()
        jax.block_until_ready(self.junctions)
        m.stop("scan")

    def pair_counts(self):
        """Host dict: pair-hash key -> count (consumed by disentangle)."""
        from faucet_tpu.graph.build import extract_table

        t = extract_table(self.pairs)
        return {(int(h) << 32) | int(l): int(c)
                for h, l, c in zip(t["hi"], t["lo"], t["v0"])}

    # ---- phases 3-5 ------------------------------------------------------
    def build(self) -> ContigGraph:
        m = self.metrics
        # defensive: callers driving scan_batch directly (tests, custom
        # flows) may not have hit a phase-end flush
        self.flush_junctions()
        if self.traversals is not None:
            m.add("traversal_rows", int(self.traversals.count))
            m.add("traversals_dropped", int(self.traversals.dropped))
            self.junctions = self._jcov(self.junctions, self.traversals,
                                        cfg=self.cfg)
            self.traversals = None
        if self.cfg.prune_slot_cov > 0:
            from faucet_tpu.dist.sharded import prune_slots

            self.junctions = prune_slots(self.junctions,
                                         self.cfg.prune_slot_cov)
        m.start("build")
        g = GraphBuilder(self.cfg, self.cascade, self.junctions,
                         self.sinks).build()
        m.stop("build")
        m.add("junctions", int(self.junctions.count))
        m.add("junctions_dropped", int(self.junctions.dropped))
        m.add("sink_anchors", int(self.sinks.count))
        m.add("sinks_dropped", int(self.sinks.dropped))
        m.add("contigs_raw", len(g.live()))
        return g

    def _pair_count_fn(self):
        """Host pair-evidence lookup over node k-mer strings, or None."""
        counts = self.pair_counts()
        if not counts:
            return None
        from faucet_tpu.core.hashing import pair_key_np
        from faucet_tpu.core.kmer import encode_kmer

        def pc(a: str, b: str) -> int:
            ah, al = encode_kmer(a)
            bh, bl = encode_kmer(b)
            kh, kl = pair_key_np(np.uint32(ah), np.uint32(al),
                                 np.uint32(bh), np.uint32(bl))
            return counts.get((int(kh) << 32) | int(kl), 0)

        return pc

    def clean_graph(self, g: ContigGraph) -> ContigGraph:
        cfg = self.cfg
        if cfg.no_cleaning:
            return g
        m = self.metrics
        m.start("clean")
        st = clean(g,
                   max_tip_len=int(cfg.tip_len_factor * cfg.max_read_length),
                   min_cov=cfg.min_contig_cov,
                   pair_count=(self._pair_count_fn()
                               if cfg.paired_ends else None))
        m.stop("clean")
        for k, v in st.items():
            m.add(f"clean_{k}", v)
        return g

    # ---- end-to-end ------------------------------------------------------
    def run_file_mode(self, load_reads: Iterable[str],
                      scan_reads: Iterable[str]) -> ContigGraph:
        """Two-pass mode (-read_load_file / -read_scan_file)."""
        self.load_reads(load_reads)
        self.scan_reads(scan_reads)
        g = self.build()
        g = self.clean_graph(g)
        self.metrics.add("contigs", len(g.live()))
        self.metrics.emit("assembly_done", stats=g.stats())
        return g

    def run_streaming(self, reads: Iterable[str]) -> ContigGraph:
        """Single-pass stream: each batch is inserted, then scanned.

        Like the reference's pipe mode, junction discovery early in the
        stream sees a partially-filled B; later traversals of the same
        loci repair coverage (SURVEY.md §3.1 note on interleaving).
        With --paired_ends the stream is interleaved mates: both mate
        batches are inserted, then pair-scanned (VERDICT r1 weak #6).
        """
        m = self.metrics
        m.start("stream")
        if self.cfg.paired_ends:
            from faucet_tpu.io.fastq import deinterleave

            m1, m2 = [], []
            for a, b in deinterleave(iter(reads)):
                m1.append(a)
                m2.append(b)
                if len(m1) == self.cfg.batch_reads:
                    self._stream_pair_batch(m1, m2)
                    m1, m2 = [], []
            if m1:
                self._stream_pair_batch(m1, m2)
        else:
            for bases, lens in batch_iter(reads, self.cfg):
                self.stream_step(bases, lens)
        self.flush_junctions()
        jax.block_until_ready(self.junctions)
        m.stop("stream")
        g = self.build()
        g = self.clean_graph(g)
        self.metrics.add("contigs", len(g.live()))
        self.metrics.emit("assembly_done", stats=g.stats())
        return g

    def _stream_pair_batch(self, m1: List[str], m2: List[str]):
        pad = self.cfg.batch_reads - len(m1)
        b1, l1 = pack_reads(m1 + [""] * pad, self.cfg.max_read_length)
        b2, l2 = pack_reads(m2 + [""] * pad, self.cfg.max_read_length)
        self._start_stream()
        self.load_batch(b1, l1)
        self.load_batch(b2, l2)
        self._scan_pair_packed(b1, l1, b2, l2)

    def run_streaming_batches(self, batches) -> ContigGraph:
        """Single-pass stream over PACKED batches (native C++ reader
        path, VERDICT r2 weak #4): each batch is inserted, then scanned;
        with paired_ends, mates are the alternating rows of each batch
        (load both halves, then pair-scan)."""
        from faucet_tpu.io.stream import prefetch_batches

        m = self.metrics
        m.start("stream")
        for bases, lens in prefetch_batches(batches):
            if self.cfg.paired_ends:
                b1, l1 = bases[0::2], lens[0::2]
                b2, l2 = bases[1::2], lens[1::2]
                self._start_stream()
                self.load_batch(b1, l1)
                self.load_batch(b2, l2)
                self._scan_pair_packed(b1, l1, b2, l2)
            else:
                self.stream_step(bases, lens)
        self.flush_junctions()
        jax.block_until_ready(self.junctions)
        m.stop("stream")
        g = self.build()
        g = self.clean_graph(g)
        self.metrics.add("contigs", len(g.live()))
        self.metrics.emit("assembly_done", stats=g.stats())
        return g
