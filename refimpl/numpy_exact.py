"""M0 golden model: exact-membership, sequential, pure-Python assembler.

This is SURVEY.md §A implemented verbatim as readable code — the
executable behavioral spec of the framework. The device pipeline in exact
mode must produce the *identical* contig multiset (differential tests in
tests/golden/); Bloom mode then differs only by false-positive noise that
cleaning removes.

Semantics pinned here (and mirrored by the device pipeline):
- two-level cascade: `seen` (≥1 occurrence) and `solid` (≥2), exact sets
  standing in for Bloom filters A and B (SURVEY.md §A.2);
- junction: canonical k-mer with ≥2 solid single-base extensions on either
  side (§A.3); junction-ness is a pure function of (k-mer, solid-set), so
  dense scanning and the reference's sequential scanning agree;
- per-slot cov/dist bookkeeping in the 8-slot canonical convention
  (core/slots.py), dist = max observed bases to the next junction within a
  read segment or to the segment end (§A.3-4);
- read-end sink anchors recorded only for junction-free read segments
  (§A.4 caps; junction-containing reads are reachable from junctions, so
  their ends need no anchor — an intentional simplification vs the
  reference's cap chains, see walk rules below);
- walks: from every covered junction slot, extend by the unique solid
  base; stop at a junction, at a dead end (trimming any Bloom-FP tail back
  to the recorded dist), on ambiguity (≥2 solid candidates at an unknown
  node — only possible under Bloom FPs), or at the global bound (§A.6);
- junction-free components are rebuilt from surviving sink anchors
  (pass 2), with cycle detection for circular components.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from faucet_tpu.core.kmer import revcomp_seq
from faucet_tpu.core.slots import entry_slot, exit_slot
from faucet_tpu.graph.model import Contig, ContigGraph, End

BASES = "ACGT"
_CODE = {c: i for i, c in enumerate(BASES)}


def canon(s: str) -> str:
    r = revcomp_seq(s)
    return s if s <= r else r


class ExactAssembler:
    def __init__(self, k: int, max_contig_len: int = 200_000,
                 paired_ends: bool = False):
        assert k % 2 == 1
        self.k = k
        self.max_contig_len = max_contig_len
        self.paired_ends = paired_ends
        self.seen: set = set()    # filter A analogue: canonical, seen >= 1
        self.solid: set = set()   # filter B analogue: canonical, seen >= 2
        # canonical kmer -> {'cov': [8], 'dist': [8]}
        self.junctions: Dict[str, Dict[str, List[int]]] = {}
        self.sinks: Dict[str, int] = {}
        self.pairs: Dict[Tuple[str, str], int] = {}
        self._branch_cache: Dict[str, bool] = {}

    # ---- phase 1: cascade load -----------------------------------------
    def load_read(self, read: str):
        for _, seg in self._segments(read):
            for i in range(len(seg) - self.k + 1):
                c = canon(seg[i : i + self.k])
                if c in self.seen:
                    self.solid.add(c)
                else:
                    self.seen.add(c)

    def load(self, reads):
        for r in reads:
            self.load_read(r)

    # ---- membership ----------------------------------------------------
    def is_solid(self, c: str) -> bool:
        return c in self.solid

    def is_branch(self, c: str) -> bool:
        """>=2 solid right-extensions or >=2 solid left-extensions of the
        canonical k-mer c (the dense 8-way probe, SURVEY.md §3.2)."""
        hit = self._branch_cache.get(c)
        if hit is not None:
            return hit
        right = sum(self.is_solid(canon(c[1:] + b)) for b in BASES)
        left = sum(self.is_solid(canon(b + c[:-1])) for b in BASES)
        res = right >= 2 or left >= 2
        self._branch_cache[c] = res
        return res

    # ---- phase 2: scan -------------------------------------------------
    def _segments(self, read: str):
        """Maximal ACGT runs of length >= k: (offset, substring)."""
        read = read.upper()
        i, n = 0, len(read)
        while i < n:
            if read[i] in BASES:
                j = i
                while j < n and read[j] in BASES:
                    j += 1
                if j - i >= self.k:
                    yield i, read[i:j]
                i = j
            else:
                i += 1

    def scan_read(self, read: str) -> List[str]:
        """Scan one read; returns the junction canonicals it crossed
        (consumed by pair capture).

        The scan operates on maximal runs of *solid* windows: the graph is
        the solid-k-mer subgraph, so singleton (error) windows neither take
        part in junction tests nor become sink anchors — they merely split
        the read into independent solid runs (SURVEY.md §A.3-4).
        """
        k = self.k
        hits: List[str] = []
        for _, seg in self._segments(read):
            P = len(seg) - k + 1
            canons = [canon(seg[p : p + k]) for p in range(P)]
            cisf = [seg[p : p + k] == canons[p] for p in range(P)]
            solid = [self.is_solid(c) for c in canons]
            p = 0
            while p < P:
                if not solid[p]:
                    p += 1
                    continue
                q = p
                while q + 1 < P and solid[q + 1]:
                    q += 1
                self._scan_run(seg, canons, cisf, p, q, hits)
                p = q + 1
        return hits

    def _scan_run(self, seg, canons, cisf, a, b, hits):
        """Process one maximal solid run: windows a..b inclusive."""
        k = self.k
        j_idx = [p for p in range(a, b + 1) if self.is_branch(canons[p])]
        # BOTH run-end k-mers become sink/cap anchors — including run
        # ends INSIDE junction-containing reads (SURVEY.md §3.2 "at read
        # end mid-path: record/update sink", §A.4). Caps mark how deep
        # real read coverage reaches along a path; pass-1 walks trim
        # Bloom-FP tails back to the DEEPEST cap instead of to the
        # junction's own dist bound, which only sees reads that touched
        # the junction (VERDICT r1 missing-#2).
        self.sinks[canons[a]] = self.sinks.get(canons[a], 0) + 1
        self.sinks[canons[b]] = self.sinks.get(canons[b], 0) + 1
        if not j_idx:
            return
        hits.extend(canons[p] for p in j_idx)
        for t, p in enumerate(j_idx):
            j = self.junctions.setdefault(
                canons[p], {"cov": [0] * 8, "dist": [0] * 8})
            if p < b:  # read exits rightward within the solid run
                s = exit_slot(cisf[p], _CODE[seg[p + k]])
                q = j_idx[t + 1] if t + 1 < len(j_idx) else b
                j["cov"][s] += 1
                j["dist"][s] = max(j["dist"][s], q - p)
            if p > a:  # read entered from the left within the run
                s = entry_slot(cisf[p], _CODE[seg[p - 1]])
                q = j_idx[t - 1] if t > 0 else a
                j["cov"][s] += 1
                j["dist"][s] = max(j["dist"][s], p - q)

    def scan(self, reads):
        for r in reads:
            self.scan_read(r)

    def pair_count(self, a: str, b: str) -> int:
        """Pair-evidence lookup for graph/clean.py::disentangle."""
        key = (a, b) if a <= b else (b, a)
        return self.pairs.get(key, 0)

    def scan_pairs(self, mates1, mates2):
        """Paired-end junction pair capture (SURVEY.md §3.4)."""
        for r1, r2 in zip(mates1, mates2):
            h1 = set(self.scan_read(r1))
            h2 = set(self.scan_read(r2))
            for a in h1:
                for b in h2:
                    key = (a, b) if a <= b else (b, a)
                    self.pairs[key] = self.pairs.get(key, 0) + 1

    # ---- phase 3: build -------------------------------------------------
    def _extend(self, w: str, first_base: Optional[int] = None):
        """Walk rightward in travel frame from k-mer w.

        Returns (appended_bases str, end End|None, circular bool, steps).
        """
        k = self.k
        bases = []
        cur = w
        nb = first_base
        while len(bases) < self.max_contig_len:
            if nb is None:
                cands = [b for b in range(4)
                         if self.is_solid(canon(cur[1:] + BASES[b]))]
                if len(cands) != 1:
                    return "".join(bases), None, False, len(bases)
                nb = cands[0]
            prev = cur[0]
            cur = cur[1:] + BASES[nb]
            bases.append(BASES[nb])
            nb = None
            if cur == w:
                return "".join(bases), None, True, len(bases)
            c = canon(cur)
            if c in self.junctions:
                # prev is the base preceding cur's window in travel frame
                s = entry_slot(cur == c, _CODE[prev])
                return "".join(bases), End(c, s), False, len(bases)
        return "".join(bases), None, False, len(bases)

    def walk_from(self, node: str, slot: int) -> Contig:
        """Pass-1 walk out of a junction slot (SURVEY.md §3.5)."""
        j = self.junctions[node]
        if slot < 4:
            w, fb = node, slot
        else:
            w, fb = revcomp_seq(node), 3 - (slot - 4)
        bases, end, circular, steps = self._extend(w, first_base=fb)
        dist = j["dist"][slot]
        if end is None and not circular and steps > dist:
            # trim the Bloom-FP tail back to real coverage: the deepest
            # walked k-mer that is a sink/cap anchor (every read's run
            # end is one), or the junction's dist bound if deeper
            seq_full = w + bases
            keep = dist
            for p in range(steps, dist, -1):
                if canon(seq_full[p : p + self.k]) in self.sinks:
                    keep = p
                    break
            if keep:
                bases = bases[:keep]
        seq = w + bases
        cov_terms = [j["cov"][slot]]
        if end is not None:
            cov_terms.append(self.junctions[end.node]["cov"][end.slot])
        cov = sum(cov_terms) / len(cov_terms)
        if circular:
            return Contig(seq=seq[: steps], cov=cov, circular=True)
        return Contig(seq=seq, cov=cov, left=End(node, slot), right=end)

    def walk_component(self, start: str) -> Contig:
        """Pass-2 walk over a junction-free component seeded at a sink."""
        r_bases, r_end, r_circ, _ = self._extend(start)
        cov = float(self.sinks.get(start, 1))
        if r_circ:
            return Contig(seq=(start + r_bases)[: len(r_bases)], cov=cov,
                          circular=True)
        l_bases, l_end, _, _ = self._extend(revcomp_seq(start))
        seq = revcomp_seq(revcomp_seq(start) + l_bases) + r_bases
        left = None if l_end is None else End(l_end.node, l_end.slot)
        return Contig(seq=seq, cov=cov, left=left, right=r_end)

    def build(self) -> ContigGraph:
        k = self.k
        by_key: Dict[str, Contig] = {}
        for node in sorted(self.junctions):
            j = self.junctions[node]
            for slot in range(8):
                if j["cov"][slot] <= 0:
                    continue
                c = self.walk_from(node, slot)
                by_key.setdefault(c.canonical_seq(), c)
        visited = set()
        for c in by_key.values():
            for i in range(len(c.seq) - k + 1):
                visited.add(canon(c.seq[i : i + k]))
        for sink in sorted(self.sinks):
            if sink in visited or sink in self.junctions:
                continue
            c = self.walk_component(sink)
            key = c.canonical_seq()
            if key in by_key:
                continue
            by_key[key] = c
            src = c.seq + (c.seq[: k - 1] if c.circular else "")
            for i in range(len(src) - k + 1):
                visited.add(canon(src[i : i + k]))
        return ContigGraph(k, list(by_key.values()))

    # ---- one-call pipeline ----------------------------------------------
    def assemble(self, reads) -> ContigGraph:
        self.load(reads)
        self.scan(reads)
        return self.build()
