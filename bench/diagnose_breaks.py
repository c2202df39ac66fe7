#!/usr/bin/env python
"""Break diagnosis for Mbp-scale truth-unitig recovery (VERDICT r3 #1).

For each truth unitig NOT intact in any assembled contig, locate every
break position and classify its cause by inspecting the graph around the
breakpoint k-mer:

  bubble-arm-survived : breakpoint node still carries a short parallel
                        arm that pop_bubbles should have removed
  tip-survived        : breakpoint node carries a short dead-end stub
  uncollapsed-1-1     : node is 1-in/1-out but the two contigs were not
                        merged (port bug)
  no-node-gap         : no junction node near the break — the covering
                        walks themselves ended (trim / END_AMBIG / cap)
  real-branch         : node has >=2 comparable-coverage arms (repeat)

Usage:
  python bench/diagnose_breaks.py --mbp 1.0           # run + analyze
  python bench/diagnose_breaks.py --reanalyze         # re-analyze only
Writes the pipeline state pickle to --pkl so classification logic can be
iterated without re-running the 100-500 s pipeline.
"""
import argparse
import json
import os
import pickle
import sys
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def run_pipeline(args):
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import copy

    from faucet_tpu import simulate as SIM
    from faucet_tpu.config import Config
    from faucet_tpu.metrics import Metrics
    from faucet_tpu.pipeline import Pipeline, batch_iter
    from faucet_tpu.graph.clean import clean
    from refimpl.unitigs import genome_graph

    G = int(args.mbp * 1e6)
    rng = np.random.default_rng(args.seed)
    genome = SIM.genome_with_repeats(rng, G, n_repeats=max(4, G // 250_000),
                                     repeat_len=400)
    reads = SIM.shred(rng, genome, coverage=args.coverage, read_len=100,
                      err_rate=args.err, circular=True)
    n_kmers = len(genome) - args.k + 1
    cfg = Config(size_kmer=args.k, max_read_length=100,
                 batch_reads=args.batch, estimated_kmers=n_kmers,
                 singletons=int(len(reads) * 100 * args.err * args.k)
                 + n_kmers,
                 junction_capacity=1 << 20, sink_capacity=4 * n_kmers,
                 fp_rate=0.01)
    p = Pipeline(cfg, Metrics())
    p.load_batches(batch_iter(reads, cfg))
    p.scan_batches(batch_iter(reads, cfg))
    g = p.build()
    pre = copy.deepcopy(g)
    stats = clean(g, max_tip_len=int(cfg.tip_len_factor
                                     * cfg.max_read_length),
                  min_cov=cfg.min_contig_cov)
    tg = genome_graph(genome, args.k, circular=True)
    truth = [tg.contigs[i].seq for i in tg.live()]
    state = {"genome": genome, "truth": truth, "k": args.k,
             "pre": pre, "post": g, "clean_stats": stats,
             "mbp": args.mbp}
    with open(args.pkl, "wb") as f:
        pickle.dump(state, f)
    return state


def find_breaks(t: str, hay: str, k: int):
    """Positions in truth unitig t where contig coverage breaks: greedy
    longest-contained-prefix sweep. Returns list of break positions."""
    from quality import longest_true_prefix

    breaks = []
    p = 0
    n = len(t)
    while p < n:
        pre = longest_true_prefix(t[p:], hay)
        if p + pre >= n:
            break
        # break in (p+pre-1, p+pre); re-anchor past the break with k-1
        # overlap so the next segment's containment is meaningful
        breaks.append(p + pre)
        p = max(p + pre - k + 1, p + 1)
        # skip ahead: find next position whose k-window is in hay
        while p < n - k and t[p:p + k] not in hay:
            p += 1
        if p >= n - k:
            break
    return breaks


def classify_break(g, t, bp, k):
    """Inspect the graph around truth position bp; return (class, info)."""
    from faucet_tpu.core.kmer import revcomp_seq

    lo = max(0, bp - 2 * k)
    hi = min(len(t) - k + 1, bp + 2 * k)
    nodes_here = []
    for i in range(lo, hi):
        w = t[i:i + k]
        key = min(w, revcomp_seq(w))
        if key in g.ports:
            nodes_here.append((abs(i + k // 2 - bp), key, i))
    if not nodes_here:
        return "no-node-gap", {}
    nodes_here.sort()
    _, node, npos = nodes_here[0]
    d = g.ports[node]
    arms = []
    for slot, (ci, end) in sorted(d.items()):
        c = g.contigs[ci]
        far = c.right if end == "L" else c.left
        arms.append({"slot": slot, "len": len(c.seq),
                     "cov": round(c.cov, 1),
                     "far": (far.node[:8] + "..") if far else None,
                     "open": far is None})
    r = sum(1 for s in d if s < 4)
    l = sum(1 for s in d if s >= 4)
    info = {"node_ports": len(d), "deg": (r, l), "arms": arms,
            "n_nodes_near": len(nodes_here)}
    if len(d) == 2 and r == 1 and l == 1:
        return "uncollapsed-1-1", info
    covs = sorted((a["cov"] for a in arms), reverse=True)
    short_weak = [a for a in arms
                  if a["len"] <= 3 * k and a["cov"] <= 0.5 * covs[0]]
    if short_weak:
        kind = "tip-survived" if any(a["open"] for a in short_weak) \
            else "bubble-arm-survived"
        return kind, info
    return "real-branch-or-other", info


def analyze(state, max_detail=12):
    from faucet_tpu.core.kmer import revcomp_seq

    g = state["post"]
    truth = state["truth"]
    k = state["k"]
    contigs = [g.contigs[i].seq for i in g.live()]
    hay = "\x00".join(contigs)
    hay = hay + "\x00" + revcomp_seq(hay.replace("\x00", "\x01")) \
        .replace("\x01", "\x00")
    missed = [t for t in truth if t not in hay]
    print(f"[diag] {len(missed)}/{len(truth)} truth unitigs broken; "
          f"clean_stats={state['clean_stats']}")
    cls = Counter()
    details = []
    for t in missed:
        bps = find_breaks(t, hay, k)
        for bp in bps:
            c, info = classify_break(g, t, bp, k)
            cls[c] += 1
            if len(details) < max_detail:
                details.append({"unitig_len": len(t), "bp": bp,
                                "class": c, **info})
    print(f"[diag] break classes: {dict(cls)}")
    for d in details:
        print(json.dumps(d, default=str))
    # also classify against the PRE-clean graph for the no-node cases
    return cls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=1.0)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--err", type=float, default=0.005)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--pkl", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "diag.pkl"))
    ap.add_argument("--reanalyze", action="store_true")
    args = ap.parse_args()
    if args.reanalyze:
        with open(args.pkl, "rb") as f:
            state = pickle.load(f)
    else:
        state = run_pipeline(args)
    analyze(state)


if __name__ == "__main__":
    main()
