#!/usr/bin/env python
"""Shard-scaling measurement (BASELINE north star ">=80% scaling
efficiency, 1 host -> 2 hosts").

Runs the full sharded stream pass (owner-routed load + scan,
dist/sharded.py) at every power-of-two shard count up to the number of
JAX devices, over identical inputs, and reports reads/s and parallel
efficiency against the 1-shard run, with the device it ran on. On the
CPU (e.g. XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu) the virtual devices time-share the host cores, so
those numbers exercise the harness only and are not device numbers.
Writes bench/scaling.json.

Usage: python bench/scaling.py [--reads 65536] [--genome 500000]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402


def run_one(n_shards: int, reads, cfg_kw) -> float:
    import jax.numpy as jnp

    from faucet_tpu.config import Config
    from faucet_tpu.dist.mesh import make_mesh
    from faucet_tpu.dist.sharded import ShardedPipeline
    from faucet_tpu.pipeline import Pipeline, batch_iter

    cfg = Config(n_shards=n_shards, **cfg_kw)
    if n_shards == 1:
        pipe = Pipeline(cfg)
    else:
        pipe = ShardedPipeline(cfg, make_mesh(n_shards))
    batches = [(jnp.asarray(b), jnp.asarray(l))
               for b, l in batch_iter(reads, cfg)]
    # warmup/compile on the first batch
    pipe.load_batch(*batches[0])
    pipe.scan_batch(*batches[0])
    jax.block_until_ready(pipe.junctions.keys_hi)
    t0 = time.perf_counter()
    for b, l in batches:
        pipe.load_batch(b, l)
    for b, l in batches:
        pipe.scan_batch(b, l)
    np.asarray(jax.tree_util.tree_leaves(pipe.junctions)[0])[:1]
    jax.block_until_ready(pipe.junctions.keys_hi)
    dt = time.perf_counter() - t0
    n_reads = sum(int((np.asarray(l) > 0).sum()) for _, l in batches)
    return n_reads / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--genome", type=int, default=500_000)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--out", default=os.path.join(REPO, "bench",
                                                  "scaling.json"))
    args = ap.parse_args()

    from faucet_tpu import simulate as SIM

    rng = np.random.default_rng(0)
    genome = SIM.genome_with_repeats(rng, args.genome, n_repeats=4,
                                     repeat_len=400)
    reads = SIM.shred(rng, genome, coverage=1.0, read_len=100,
                      err_rate=0.005)
    reads = (reads * (args.reads // len(reads) + 1))[: args.reads]
    cfg_kw = dict(size_kmer=args.k, max_read_length=100,
                  batch_reads=8192, estimated_kmers=args.genome,
                  singletons=4 * args.genome,
                  junction_capacity=1 << 16, sink_capacity=1 << 19,
                  fp_rate=0.01)
    rows = []
    base = None
    n_dev = len(jax.devices())
    for n in (1, 2, 4, 8):
        if n > n_dev:
            break
        rps = run_one(n, reads, cfg_kw)
        if base is None:
            base = rps
        eff = rps / (base * n)
        rows.append({"n_shards": n, "reads_per_s": round(rps, 1),
                     "efficiency_vs_1shard": round(eff, 4)})
        print(f"[scaling] n={n}: {rps:,.0f} reads/s "
              f"(eff {eff:.2%})", file=sys.stderr, flush=True)
    d = jax.devices()[0]
    rec = {
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": n_dev},
        "reads": args.reads,
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
