"""Phase-3 graph build: device walks -> host ContigGraph.

Reference analogue: ContigGraph::buildGraph driving BF walks from every
covered junction slot (ref:src/ContigGraph.cpp, SURVEY.md §3.1 PHASE 3
[C:high]). Device re-design: all walks run as one lockstep device frontier
(graph/walk.py); the host only decodes the resulting base strips and
assembles Contig records. Pass 2 rebuilds junction-free components from
sink anchors in chunks, filtering later sinks through the k-mers already
visited (SURVEY.md §A.6 and refimpl/numpy_exact.py build()).

Width handling: a codec object hides the difference between narrow
(k<=31: table keys ARE the canonical codes) and wide (k>31: fingerprint
keys + stored 4-word codes, core/wide.py) representations.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from faucet_tpu.core import bloom as BL
from faucet_tpu.core import kmer as KM
from faucet_tpu.core import table as T
from faucet_tpu.core.kmer import decode_kmer, revcomp_code_np, revcomp_seq
from faucet_tpu.graph import walk as W
from faucet_tpu.dist.mesh import fetch
from faucet_tpu.graph.model import Contig, ContigGraph, End

_CODEBOOK = "ACGT"


def _to_int(hi, lo):
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64)


_SENT = np.uint32(0xFFFFFFFF)


def extract_table(tbl: T.Table):
    """Occupied rows of a device table -> host numpy dict.

    Multi-host: each process filters only its ADDRESSABLE shard rows
    and the processes all-gather the occupied ROWS (the walk seeds) —
    the capacity-sized global arrays are never materialized on any
    host (VERDICT r4 #8: the per-host global fetch was config-4/5's
    first memory wall; PARITY.md §config5). Gathered row order is
    process-major, but build() sorts every extract by key immediately,
    so contigs are order-independent. Sets extract_table.last_bytes to
    the bytes this host materialized (asserted by the multihost test).
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        def local(a):
            # one copy per distinct row range (a replicated leaf shows
            # every device the same range; keep it once)
            seen = {}
            for s in a.addressable_shards:
                seen.setdefault(s.index[0].start or 0, s.data)
            return np.concatenate(
                [np.asarray(d) for _, d in sorted(seen.items())])

        keys_hi = local(tbl.keys_hi)
        occ = keys_hi != _SENT
        cols = {"hi": keys_hi[occ], "lo": local(tbl.keys_lo)[occ]}
        for i, v in enumerate(tbl.vals):
            cols[f"v{i}"] = local(v)[occ]
        n = cols["hi"].shape[0]
        counts = np.asarray(multihost_utils.process_allgather(
            jnp.asarray([np.int64(n)])))
        maxn = int(counts.max())

        def gather(a, fill):
            pad = np.full((maxn,) + a.shape[1:], fill, a.dtype)
            pad[:n] = a
            g = np.asarray(multihost_utils.process_allgather(
                jnp.asarray(pad)))  # [nproc, maxn, ...]
            return g.reshape((-1,) + a.shape[1:])

        hi_all = gather(cols["hi"], _SENT)
        keep = hi_all != _SENT
        out = {"hi": hi_all[keep], "lo": gather(cols["lo"], 0)[keep]}
        for i in range(len(tbl.vals)):
            out[f"v{i}"] = gather(cols[f"v{i}"], 0)[keep]
        extract_table.last_bytes = sum(
            a.nbytes for a in cols.values()) + sum(
            a.nbytes for a in out.values()) * jax.process_count()
        return out
    keys_hi = fetch(tbl.keys_hi)
    occ = keys_hi != _SENT
    out = {
        "hi": keys_hi[occ],
        "lo": fetch(tbl.keys_lo)[occ],
    }
    for i, v in enumerate(tbl.vals):
        out[f"v{i}"] = fetch(v)[occ]
    extract_table.last_bytes = keys_hi.nbytes * (
        2 + sum(int(np.prod(v.shape[1:])) for v in tbl.vals))
    return out


def _pad_pow2(n: int, lo: int = 256) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class _NarrowCodec:
    """k <= 31: table keys are the canonical 2-word codes."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.k = cfg.size_kmer

    def seed_payload(self, t, rows):
        return {"hi": t["hi"][rows], "lo": t["lo"][rows]}

    def node_strs(self, t, rows):
        from faucet_tpu.core.kmer import decode_kmers_np

        keys = _to_int(t["hi"], t["lo"])[np.asarray(rows, np.int64)]
        return decode_kmers_np(keys, self.k)

    def key_windows(self, s: str) -> np.ndarray:
        """uint64 table keys of every canonical k-window of a string."""
        from faucet_tpu.core.kmer import encode_windows_np

        return encode_windows_np(s, self.k)

    def make_frontier(self, payload, dirs, forced, active, circle_ok,
                      pad):
        chi = pad(payload["hi"], 0)
        clo = pad(payload["lo"], 0)
        rc = revcomp_code_np(_to_int(chi, clo), self.k)
        return W.make_frontier(
            jnp.asarray(chi), jnp.asarray(clo),
            jnp.asarray((rc >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((rc & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray(pad(np.asarray(dirs, np.int32), 0)),
            jnp.asarray(pad(np.asarray(forced, np.int32), -1)),
            jnp.asarray(active),
            jnp.asarray(pad(np.asarray(circle_ok, bool), False)))

    def walk_round(self):
        return W.walk_round

    def resolver(self):
        return W.resolve_ambiguous

    def end_state(self, fr):
        """Host snapshot of every lane's endpoint key material."""
        chi, clo, _ = KM.canon_of(fr.fhi, fr.flo, fr.rhi, fr.rlo)
        return {"hi": fetch(chi), "lo": fetch(clo)}

    def end_keys(self, st, idx):
        return _to_int(st["hi"][idx], st["lo"][idx])

    def end_str(self, st, i) -> str:
        return decode_kmer(int(st["hi"][i]), int(st["lo"][i]), self.k)

    def key_of_str(self, s: str) -> int:
        """Canonical table key of a k-mer string (host)."""
        from faucet_tpu.core.kmer import encode_kmer

        c = min(s, revcomp_seq(s))
        hi, lo = encode_kmer(c)
        return (hi << 32) | lo


class _WideCodec:
    """k > 31: fingerprint keys; true 4-word codes stored as values."""

    def __init__(self, cfg, words_col: str):
        self.cfg = cfg
        self.k = cfg.size_kmer
        self.words_col = words_col  # which v<i> holds the codes

    def seed_payload(self, t, rows):
        return {"words": t[self.words_col][rows]}

    def node_strs(self, t, rows):
        from faucet_tpu.core.wide import decode_kmer_wide

        return [decode_kmer_wide(t[self.words_col][i], self.k)
                for i in rows]

    def make_frontier(self, payload, dirs, forced, active, circle_ok,
                      pad):
        from faucet_tpu.core.wide import revcomp_words_np

        words = payload["words"]  # [n, 4] uint32
        rcw = revcomp_words_np(np.asarray(words, np.uint32), self.k)
        wpad = lambda a: pad(np.ascontiguousarray(a), 0)
        cw = tuple(jnp.asarray(wpad(words[:, j])) for j in range(4))
        rw = tuple(jnp.asarray(wpad(rcw[:, j])) for j in range(4))
        return W.make_frontier_wide(
            cw, rw,
            jnp.asarray(pad(np.asarray(dirs, np.int32), 0)),
            jnp.asarray(pad(np.asarray(forced, np.int32), -1)),
            jnp.asarray(active),
            jnp.asarray(pad(np.asarray(circle_ok, bool), False)))

    def walk_round(self):
        return W.walk_round_wide

    def resolver(self):
        return W.resolve_ambiguous_wide

    def end_state(self, fr):
        from faucet_tpu.core.wide import canon_of_wide, fingerprint

        canon, _ = canon_of_wide(fr.fwd, fr.rc)
        khi, klo = fingerprint(canon)
        return {"hi": fetch(khi), "lo": fetch(klo),
                "words": np.stack([fetch(w) for w in canon], axis=1)}

    def end_keys(self, st, idx):
        return _to_int(st["hi"][idx], st["lo"][idx])

    def end_str(self, st, i) -> str:
        from faucet_tpu.core.wide import decode_kmer_wide

        return decode_kmer_wide(st["words"][i], self.k)

    def key_of_str(self, s: str) -> int:
        from faucet_tpu.core.wide import encode_kmer_wide, fingerprint_np

        c = min(s, revcomp_seq(s))
        hi, lo = fingerprint_np(
            tuple(np.uint32(w) for w in encode_kmer_wide(c)))
        return (int(hi) << 32) | int(lo)

    def key_windows(self, s: str) -> np.ndarray:
        from faucet_tpu.core.wide import encode_windows_wide_np

        return encode_windows_wide_np(s, self.k)


class GraphBuilder:
    def __init__(self, cfg, cascade: BL.Cascade, junctions: T.Table,
                 sinks: T.Table, mesh=None):
        self.cfg = cfg
        self.cascade = cascade
        self.junctions = junctions
        self.sinks = sinks
        # owner-routed walks (dist/swalk.py): explicit all_to_all per
        # hop over the mesh, with routed-byte accounting — narrow codes
        # only (wide fingerprint walks fall back to GSPMD partitioning)
        self.mesh = mesh if (mesh is not None and cfg.route_walks
                             and not cfg.wide) else None
        self.route_bytes = 0
        if cfg.wide:
            self.codec_j = _WideCodec(cfg, "v2")
            self.codec_s = _WideCodec(cfg, "v1")
        else:
            self.codec_j = self.codec_s = _NarrowCodec(cfg)
        self._jitted = {}

    def _wave_fn(self, codec):
        key = (codec.walk_round(), "waves")
        if key not in self._jitted:
            self._jitted[key] = jax.jit(
                W.walk_waves,
                static_argnames=("n_rounds", "n_steps", "cfg",
                                 "walk_fn", "resolve_fn"))
        return self._jitted[key]

    # ---- device walk driver --------------------------------------------
    @staticmethod
    def _gather_frontier(fr, idx: np.ndarray, newp: int):
        """Compact a frontier to the idx lanes, padded to newp (host
        round-trip; shapes stay on the pow2 ladder so the wave jit cache
        is reused across shrinks and across _run_walks calls)."""
        m = len(idx)

        def g(leaf):
            a = np.asarray(fetch(leaf))
            out = np.zeros((newp,) + a.shape[1:], a.dtype)
            out[:m] = a[idx]
            return jnp.asarray(out)

        return jax.tree_util.tree_map(g, fr)

    def _run_walks(self, codec, payload, dirs, forced, circle_ok):
        """Run all walks to completion in lockstep waves, COMPACTING the
        frontier whenever <=1/4 of lanes are still active: a handful of
        genome-length walks must not drag the full lane grid through
        every step (VERDICT r2 weak #3: total walk work is ~sum of walk
        lengths, not lanes x max_contig_len)."""
        cfg = self.cfg
        n = len(dirs)
        assert n > 0
        Wp = _pad_pow2(n)

        def pad(a, fill):
            a = np.asarray(a)
            out = np.full((Wp,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n] = a
            return out

        active = np.zeros(Wp, bool)
        active[:n] = True
        fr = codec.make_frontier(payload, dirs, forced, active,
                                 circle_ok, pad)
        waves = self._wave_fn(codec)
        orig = np.arange(Wp)  # current lane -> original lane
        # per-ORIGINAL-lane live bases, compressed per wave call: device
        # AND host strip memory stay bounded at [Wp, rounds*steps] per
        # call while the total held is just the walked bases (ADVICE r2)
        parts: List[List[np.ndarray]] = [[] for _ in range(n)]
        res_kind = np.zeros(n, np.int32)
        res_slot = np.full(n, -1, np.int32)
        res_steps = np.zeros(n, np.int32)
        res_key = np.zeros(n, np.uint64)
        res_str: List[Optional[str]] = [None] * n

        def capture(fr, lane_mask: np.ndarray):
            idx = np.nonzero(lane_mask[: len(orig)])[0]
            o = orig[idx]
            keep = o < n
            idx, o = idx[keep], o[keep]
            if not len(idx):
                return
            st = codec.end_state(fr)
            res_kind[o] = fetch(fr.end_kind)[idx]
            res_slot[o] = fetch(fr.entry_slot)[idx]
            res_steps[o] = fetch(fr.steps)[idx]
            res_key[o] = codec.end_keys(st, idx)
            for j, oi in zip(idx, o):
                if res_kind[oi] == W.END_JUNCTION:
                    res_str[oi] = codec.end_str(st, j)

        total = 0
        R = max(1, cfg.walk_rounds_per_call)
        # Warmup ramp (round-4 profile): most seeds are short error/FP-
        # island walks that retire within ~100 steps, while a full call
        # is R*steps (2048) frontier steps — 95% of the grid's work was
        # dead lanes. Two short calls first let the 1/4-live compaction
        # shrink the grid to the genuine long walks before the big
        # calls run; the (n_rounds, n_steps) jit variants are cached
        # across _run_walks calls, so this costs 2 extra compiles total.
        warmup = [(1, min(64, cfg.walk_round_steps)),
                  (1, cfg.walk_round_steps)]
        while total < cfg.max_contig_len:
            rr, ss = warmup.pop(0) if warmup else (R,
                                                   cfg.walk_round_steps)
            if self.mesh is not None:
                from faucet_tpu.dist.swalk import walk_waves_routed

                fr, bases, rb = walk_waves_routed(
                    self.mesh, self.cascade, self.junctions, fr,
                    n_rounds=rr, n_steps=ss, cfg=cfg)
                self.route_bytes += int(fetch(rb))
            else:
                fr, bases, _r = waves(self.cascade, self.junctions, fr,
                                      n_rounds=rr,
                                      n_steps=ss,
                                      cfg=cfg,
                                      walk_fn=codec.walk_round(),
                                      resolve_fn=codec.resolver())
            b = fetch(bases)
            mask = b != 255
            counts = mask.sum(axis=1)
            segs = np.split(b[mask], np.cumsum(counts)[:-1])
            for i in np.nonzero(counts[: len(orig)])[0]:
                if orig[i] < n:
                    parts[orig[i]].append(segs[i])
            total += rr * ss
            # pending = active or not-yet-judged ambiguous retirees
            # (the capped resolver may re-arm them next call) — both
            # must survive the break check AND compaction
            act = np.asarray(fetch(fr.active)) | (
                np.asarray(fetch(fr.end_kind)) == W.END_AMBIG)
            live = int(act.sum())
            if live == 0:
                break
            cur = act.shape[0]
            if live <= cur // 4 and cur > 64:
                # floor 64 (was 512): the longest-walk TAIL dominates
                # device time — ~100 wave calls of 2048 steps run after
                # the frontier drains to a handful of genome-length
                # walks, and per-call cost is grid-width-proportional
                newp = _pad_pow2(live, lo=64)
                capture(fr, ~act)
                idx = np.nonzero(act)[0]
                fr = self._gather_frontier(fr, idx, newp)
                orig = orig[idx]
        capture(fr, np.ones(np.asarray(fetch(fr.active)).shape[0], bool))
        empty = np.empty(0, np.uint8)
        return {
            "bases": [np.concatenate(p) if p else empty for p in parts],
            "end_kind": res_kind,
            "entry_slot": res_slot,
            "steps": res_steps,
            "end_key": res_key,
            "end_str": res_str,
        }

    # ---- contig assembly -------------------------------------------------
    def _strip_to_str(self, row: np.ndarray, steps: int) -> str:
        # rows arrive pre-compressed (255 idle gaps already filtered by
        # the wave driver); bound by the advance count
        return "".join(_CODEBOOK[b] for b in row[:steps])

    def build(self) -> ContigGraph:
        cfg = self.cfg
        k = cfg.size_kmer
        jt = extract_table(self.junctions)
        n_j = len(jt["hi"])
        cov8 = jt.get("v0", np.zeros((0, 8), np.int32))
        dist8 = jt.get("v1", np.zeros((0, 8), np.uint16))
        jkeys = _to_int(jt["hi"], jt["lo"])
        order = np.argsort(jkeys, kind="stable")
        for key in list(jt.keys()):
            jt[key] = jt[key][order]
        jkeys, cov8, dist8 = jkeys[order], cov8[order], dist8[order]
        jcov_by_key: Dict[int, np.ndarray] = {
            int(kk): cov8[i] for i, kk in enumerate(jkeys)}
        all_rows = list(range(n_j))
        jnode_strs = self.codec_j.node_strs(jt, all_rows) if n_j else []

        # sink/cap anchors (extracted once; pass-1 FP-trim + pass-2 seeds)
        st = extract_table(self.sinks)
        skeys = _to_int(st["hi"], st["lo"])
        order = np.argsort(skeys, kind="stable")
        for key in list(st.keys()):
            st[key] = st[key][order]
        self._sink_keys = np.sort(np.asarray(skeys, np.uint64))

        by_key: Dict[str, Contig] = {}

        # ---- pass 1: walks from every covered junction slot -------------
        # (a two-stage edge-dedupe — walk right-face seeds, skip the
        # left-face seeds whose port a stage-A walk entered — was
        # measured SLOWER at 2 Mbp: the long-walk wave tail dominates
        # and gets paid once per stage, while lane count is not the
        # cost driver under frontier compaction)
        rows, slots = np.nonzero(cov8 > 0)
        if len(rows):
            dirs = (slots >= 4).astype(np.int32)
            forced = np.where(slots < 4, slots, 3 - (slots - 4)).astype(
                np.int32)
            out = self._run_walks(self.codec_j,
                                  self.codec_j.seed_payload(jt, rows),
                                  dirs, forced, np.zeros(len(rows), bool))
            for i in range(len(rows)):
                c = self._pass1_contig(
                    jnode_strs[rows[i]], int(slots[i]), cov8[rows[i]],
                    dist8[rows[i]], out, i, jcov_by_key)
                if c is not None:
                    by_key.setdefault(c.canonical_seq(), c)

        # visited k-mers as uint64 table keys in sorted chunks — no
        # Python string churn at genome scale (VERDICT r1 #4). Chunk
        # growth is LSM-style: adjacent chunks within 2x size merge on
        # append, so the chunk count stays O(log N) for visited_mask's
        # per-chunk searchsorted while TOTAL merge work is O(N log N).
        # (The previous flat consolidate-every-48 rewrote the whole
        # visited set ~contigs/48 times: 13.6 s of a 70 s 2 Mbp build,
        # and the dominant superlinear term at 8 Mbp.)
        chunks: List[np.ndarray] = []

        def mark_visited(c: Contig):
            src = c.seq + (c.seq[: k - 1] if c.circular else "")
            w = self.codec_s.key_windows(src)
            if not len(w):
                return
            w.sort()
            chunks.append(w)
            while len(chunks) >= 2 and \
                    len(chunks[-2]) <= 2 * len(chunks[-1]):
                b = chunks.pop()
                a = chunks.pop()
                m = np.concatenate([a, b])
                m.sort()
                chunks.append(m)

        def visited_mask(keys: np.ndarray) -> np.ndarray:
            hit = np.zeros(len(keys), bool)
            for ch in chunks:
                idx = np.searchsorted(ch, keys)
                idx = np.minimum(idx, len(ch) - 1)
                hit |= ch[idx] == keys
            return hit

        for c in by_key.values():
            mark_visited(c)

        # ---- pass 2: junction-free components from sink anchors ---------
        jset = np.asarray(sorted({int(x) for x in jkeys}), np.uint64)
        n_s = len(st["hi"])
        skeys_s = _to_int(st["hi"], st["lo"])
        chunk = 4096
        pend = np.arange(n_s)[~np.isin(skeys_s, jset)]
        while len(pend):
            # filter pend in bulk (the chunk list stays O(log N) under
            # the LSM merge — no per-round full consolidation needed)
            live = ~visited_mask(skeys_s[pend])
            pend = pend[live]
            if len(pend) and not cfg.wide:
                # seeds one base OFF walked territory (error/fp anchor
                # k-mers) walk straight back onto it and produce the
                # duplicates the >50%-visited check drops post-walk;
                # skip the wasted walks by testing the 8 neighbors
                from faucet_tpu.core.kmer import neighbor_keys_np

                nbr = neighbor_keys_np(skeys_s[pend], k)
                hit = visited_mask(nbr.ravel()).reshape(nbr.shape)
                pend = pend[~hit.any(axis=1)]
            batch = pend[:chunk].tolist()
            pend = pend[chunk:]
            if not batch:
                break
            snode_strs = {i: s for i, s in zip(
                batch, self.codec_s.node_strs(st, batch))}
            new = self._pass2_contigs(st, batch, snode_strs)
            for c in new:
                key = c.canonical_seq()
                if key in by_key:
                    continue
                # Drop near-duplicates of already-walked paths: a sink
                # anchor that is itself a Bloom-fp/error k-mer one base
                # OFF a real path passes the seed-key visited filter,
                # but its walk immediately rejoins the path and re-emits
                # an existing contig (whose port attachments it would
                # then clobber — ports are one contig per slot). Genuine
                # junction-free components are ~0% visited; these junk
                # re-walks are ~100%.
                w = self.codec_s.key_windows(
                    c.seq + (c.seq[: k - 1] if c.circular else ""))
                if len(w) and visited_mask(w).mean() > 0.5:
                    continue
                by_key[key] = c
                mark_visited(c)

        g = ContigGraph(k, list(by_key.values()))
        # repair merged walks (missed-junction port clashes) before the
        # graph is handed to cleaning — see clean.resolve_port_clashes
        from faucet_tpu.graph.clean import (repair_ports,
                                            resolve_port_clashes)

        resolve_port_clashes(g)
        # surgery drops/rebuilds claimants; any end left pointing at an
        # empty (node, slot) re-registers so cleaning sees true degrees
        repair_ports(g)
        return g

    def _pass1_contig(self, node: str, slot: int, cov8, dist8, out, i,
                      jcov_by_key) -> Optional[Contig]:
        cfg = self.cfg
        k = cfg.size_kmer
        w0 = node if slot < 4 else revcomp_seq(node)
        steps = int(out["steps"][i])
        kind = int(out["end_kind"][i])
        bases = self._strip_to_str(out["bases"][i], steps)
        seq = w0 + bases
        dist = int(dist8[slot])
        if kind in (W.END_DEAD, W.END_AMBIG, W.RUNNING):
            if steps > dist:
                # trim the Bloom-FP tail back to real coverage: deepest
                # walked window that is a sink/cap anchor (every read
                # run-end is one; SURVEY.md §3.2 mid-path caps), with
                # the junction's dist bound as the floor — dist only
                # sees reads that touched the junction itself
                wk = self.codec_s.key_windows(seq[dist:])
                hits = np.nonzero(self._is_sink(wk))[0]
                keep = dist + (int(hits.max()) if len(hits) else 0)
                if keep:
                    seq = seq[: k + keep]
            cov = float(cov8[slot])
            return Contig(seq=seq, cov=cov, left=End(node, slot),
                          right=None)
        if kind == W.END_JUNCTION:
            end_key = int(out["end_key"][i])
            end_node = out["end_str"][i]
            eslot = int(out["entry_slot"][i])
            ecov = jcov_by_key.get(end_key)
            cov = (float(cov8[slot]) + (float(ecov[eslot])
                                        if ecov is not None else 0.0)) / 2
            return Contig(seq=seq, cov=cov, left=End(node, slot),
                          right=End(end_node, eslot))
        # circular cannot happen for junction-seeded walks (circle_ok off)
        return None

    def _trim_open_ends(self, seq: str, left_open: bool,
                        right_open: bool) -> str:
        """Trim Bloom-FP tail bases off walk ends that did not land on a
        junction: cut back to the outermost windows that are sink/cap
        anchors. Every read run-end is an anchor (SURVEY.md §3.2 mid-path
        caps), so real coverage always ends ON an anchor while an FP tail
        k-mer is in the sink table only by key collision — the same rule
        pass-1 applies past its dist bound (VERDICT r2 weak #2: pass-2
        contigs previously kept 1-2 junk bases per open end)."""
        if not (left_open or right_open):
            return seq
        k = self.cfg.size_kmer
        if len(seq) < k:
            return seq
        wk = self.codec_s.key_windows(seq)
        pos = np.nonzero(self._is_sink(wk))[0]
        if not len(pos):
            return seq
        lo = int(pos.min()) if left_open else 0
        hi = int(pos.max()) if right_open else len(wk) - 1
        return seq[lo:hi + k]

    def _is_sink(self, keys: np.ndarray) -> np.ndarray:
        """Membership of keys in the (pre-sorted) sink anchor set —
        np.isin re-sorts per call, which measured ~28 s of a 0.5 Mbp
        build across the per-contig trims."""
        sk = self._sink_keys
        if not len(sk):
            return np.zeros(len(keys), bool)
        idx = np.minimum(np.searchsorted(sk, keys), len(sk) - 1)
        return sk[idx] == keys

    def _pass2_contigs(self, st, batch, snode_strs) -> List[Contig]:
        cfg = self.cfg
        k = cfg.size_kmer
        n = len(batch)
        zeros = np.zeros(n, np.int32)
        payload = self.codec_s.seed_payload(st, batch)
        rout = self._run_walks(self.codec_s, payload, zeros, zeros - 1,
                               np.ones(n, bool))
        lout = self._run_walks(self.codec_s, payload, zeros + 1,
                               zeros - 1, np.ones(n, bool))
        scov = st["v0"]
        contigs = []
        for j, i in enumerate(batch):
            start = snode_strs[i]
            cov = float(scov[i])
            rsteps = int(rout["steps"][j])
            rb = self._strip_to_str(rout["bases"][j], rsteps)
            if int(rout["end_kind"][j]) == W.END_CIRCULAR:
                contigs.append(Contig(seq=(start + rb)[:rsteps], cov=cov,
                                      circular=True))
                continue
            lsteps = int(lout["steps"][j])
            lb = self._strip_to_str(lout["bases"][j], lsteps)
            seq = revcomp_seq(revcomp_seq(start) + lb) + rb
            left = None
            if int(lout["end_kind"][j]) == W.END_JUNCTION:
                left = End(lout["end_str"][j], int(lout["entry_slot"][j]))
            right = None
            if int(rout["end_kind"][j]) == W.END_JUNCTION:
                right = End(rout["end_str"][j], int(rout["entry_slot"][j]))
            seq = self._trim_open_ends(seq, left is None, right is None)
            contigs.append(Contig(seq=seq, cov=cov, left=left,
                                  right=right))
        return contigs
