#!/usr/bin/env python
"""Scale validation: end-to-end assembly on a multi-Mbp repeat-structured
synthetic, reporting per-phase wall-clock AND assembly quality vs the
exact ground truth of the generated genome (VERDICT r2 #2).

Runs on JAX's default device; --platform cpu forces the host CPU
backend (whose times are not device times).

Writes bench/scale_run.json:
  {genome_mbp, reads, synth_s,
   phase_s: {load, scan, graph_build, clean},   # contig extraction is
                                                # materialized inside
                                                # graph_build (strings
                                                # are built by the walk
                                                # decoder), so it has no
                                                # separate phase
   contigs, n50, total_contig_bases,
   truth_unitigs, truth_n50, n50_vs_truth,
   genome_true_frac, truth_recovered_frac, platform}

With --check, asserts the BASELINE-metric quality gate (exit 1 on miss):
  genome_true_frac >= 0.99, n50_vs_truth >= 0.9,
  truth_recovered_frac >= 0.95  (VERDICT r3 #1: reference-unitig
  recovery is the flagship metric and is now gated)
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from quality import assess, n50, truth_recovery  # noqa: E402  (bench/)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=4.0)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--err", type=float, default=0.005)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--check", action="store_true",
                    help="assert the quality gate (>=99%% genome-true, "
                         "N50-vs-truth >= 0.9, truth-recovered >= 0.95)")
    ap.add_argument("--out", default=os.path.join(REPO, "bench",
                                                  "scale_run.json"))
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from faucet_tpu import simulate as SIM
    from faucet_tpu.config import Config
    from faucet_tpu.metrics import Metrics
    from faucet_tpu.pipeline import Pipeline, batch_iter
    from refimpl.unitigs import genome_graph

    G = int(args.mbp * 1e6)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    genome = SIM.genome_with_repeats(rng, G, n_repeats=max(4, G // 250_000),
                                     repeat_len=400)
    # circular genome (config-1 is E. coli — a circular chromosome): a
    # LINEAR sim ramps coverage to ~0 over the last read-length, so the
    # terminal k-mers are seen <2x and can never pass the two-occurrence
    # cascade (reference semantics included) — a sim artifact, not an
    # assembler property
    reads = SIM.shred(rng, genome, coverage=args.coverage, read_len=100,
                      err_rate=args.err, circular=True)
    t_synth = time.perf_counter() - t0
    n_kmers = len(genome) - args.k + 1
    cfg = Config(size_kmer=args.k, max_read_length=100,
                 batch_reads=args.batch,
                 estimated_kmers=n_kmers,
                 singletons=int(len(reads) * 100 * args.err * args.k)
                 + n_kmers,
                 junction_capacity=1 << 20, sink_capacity=4 * n_kmers,
                 fp_rate=0.01)
    m = Metrics()
    p = Pipeline(cfg, m)
    print(f"[scale] genome={args.mbp}Mbp reads={len(reads)} "
          f"A={cfg.bloom_a_bits >> 23}MB B={cfg.bloom_b_bits >> 23}MB",
          file=sys.stderr, flush=True)

    phase_s = {}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        phase_s[name] = round(time.perf_counter() - t, 2)
        print(f"[scale] {name}: {phase_s[name]}s", file=sys.stderr,
              flush=True)
        return r

    timed("load", lambda: p.load_batches(batch_iter(reads, cfg)))
    timed("scan", lambda: p.scan_batches(batch_iter(reads, cfg)))
    g = timed("graph_build", p.build)
    g = timed("clean", lambda: p.clean_graph(g))
    contigs = [g.contigs[i].seq for i in g.live()]

    tg = genome_graph(genome, args.k, circular=True)
    truth = [tg.contigs[i].seq for i in tg.live()]
    lens = [len(c) for c in contigs]
    tlens = [len(t) for t in truth]
    rec = {
        "genome_mbp": args.mbp,
        "coverage": args.coverage,
        "err": args.err,
        "reads": len(reads),
        "synth_s": round(t_synth, 2),
        "phase_s": phase_s,
        "contigs": len(contigs),
        "n50": n50(lens),
        "total_contig_bases": int(sum(lens)),
        "truth_unitigs": len(truth),
        "truth_n50": n50(tlens),
        "n50_vs_truth": round(n50(lens) / max(n50(tlens), 1), 4),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    # doubled genome: a contig may span the circular origin
    rec.update(assess(contigs, genome + genome, args.k))
    rec.update(truth_recovery(contigs, truth, genome))
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    if args.check:
        gates = {
            "genome_true_frac": rec["genome_true_frac"] >= 0.99,
            "n50_vs_truth": rec["n50_vs_truth"] >= 0.9,
            "truth_recovered_frac": rec["truth_recovered_frac"] >= 0.95,
        }
        ok = all(gates.values())
        print(f"[scale] quality gate: {'PASS' if ok else 'FAIL'} "
              + " ".join(f"{k}={'ok' if v else 'MISS'}"
                         for k, v in gates.items()), file=sys.stderr)
        sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
