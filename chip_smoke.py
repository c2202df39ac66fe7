#!/usr/bin/env python
"""Smoke run of the assembler on one NVIDIA GPU at BASELINE config 1.

Config 1 is E. coli K-12 at 50x with 100 bp Illumina reads and k=31.
Real reads are not in the repository, so the run simulates them from
--seed: a 4,641,652 bp circular genome with planted 400 bp repeats, 50x
coverage, 0.5% substitutions (about 2.32 M reads). Filters and tables
are sized by config.py from the CLI flags below: A 64 MB, B 8 MB,
D 32 MB, E 8 MB, 2^20 junction slots, 2^23 sink slots. Nothing is cut.

Phases, each fatal on failure:
  1. device report: platform, device kind, count, nvidia-smi name and
     power limit;
  2. compile the load, scan and stream steps at config-1 shapes and
     print compiled.memory_analysis();
  3. two load+stream batches on the GPU and on the host CPU in the same
     process: filters A/B/D/E, junction, sink and traversal tables and
     n_solid must be bit-identical; the Triton insert must equal the XLA
     insert on a 64 MB filter (both timed per call);
  4. the CLI end to end, two passes over a FASTQ file, with the native
     C++ reader; the contigs must pass the bench/quality.py gates
     (genome_true_frac >= 0.99, n50_vs_truth >= 0.9,
     truth_recovered_frac >= 0.95);
  5. the CLI single-pass streaming over the same reads on stdin
     (--stream -read_load_file -), same gates.
With --four it runs only the sharded path instead: ShardedPipeline over
make_mesh(4) on the same reads must drop no routed k-mer and emit the
same contig set as the one-card Pipeline.

Usage:  python chip_smoke.py [--seed N] [--four]

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU, or outside a checkout of this repository, it fails before
printing any result.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "bench"))
WORK = os.path.join(REPO, ".smoke")

GENOME_BP = 4_641_652
COVERAGE = 50.0
READ_LEN = 100
ERR_RATE = 0.005
REPEAT_LEN = 400
K = 31
BATCH = 8192
GATES = {"genome_true_frac": 0.99, "n50_vs_truth": 0.9,
         "truth_recovered_frac": 0.95}
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration",
                  "/jax/compilation_cache/cache_retrieval_time_sec")


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cli_argv(prefix, fastq=None):
    """Config-1 flags; fastq=None streams from stdin."""
    argv = ["-size_kmer", str(K), "-max_read_length", str(READ_LEN),
            "--batch_reads", str(BATCH), "-estimated_kmers", "4641622",
            "-singletons", "40614425", "--fastq", "-file_prefix", prefix,
            "--metrics_file", prefix + ".metrics.jsonl"]
    if fastq is None:
        return argv + ["--stream", "-read_load_file", "-"]
    return argv + ["-read_load_file", fastq, "-read_scan_file", fastq]


def config_of(argv):
    from faucet_tpu import cli

    return cli.config_from_args(cli.build_parser().parse_args(argv))


# ---- set-up: reads and ground truth ----------------------------------


def make_reads(seed):
    from faucet_tpu import simulate as SIM

    rng = np.random.default_rng(seed)
    genome = SIM.genome_with_repeats(
        rng, GENOME_BP, n_repeats=max(4, GENOME_BP // 250_000),
        repeat_len=REPEAT_LEN)
    # circular: E. coli's chromosome is a circle, and a linear simulation
    # would leave the terminal k-mers under the two-occurrence cascade
    reads = SIM.shred(rng, genome, coverage=COVERAGE, read_len=READ_LEN,
                      err_rate=ERR_RATE, circular=True)
    return genome, reads


def _host_only():
    import jax

    jax.config.update("jax_platforms", "cpu")


def truth_unitigs(genome):
    """Unitigs of the genome itself (refimpl): runs in a host-only worker
    process while the device phases run."""
    from refimpl.unitigs import genome_graph

    g = genome_graph(genome, K, circular=True)
    return [g.contigs[i].seq for i in g.live()]


def quality(contigs, genome, truth):
    from quality import assess, n50, truth_recovery

    rec = {"contigs": len(contigs),
           "n50": n50([len(c) for c in contigs]),
           "truth_unitigs": len(truth),
           "truth_n50": n50([len(t) for t in truth])}
    rec["n50_vs_truth"] = rec["n50"] / max(rec["truth_n50"], 1)
    # doubled genome: a contig may span the circular origin
    rec.update(assess(contigs, genome + genome, K))
    rec.update(truth_recovery(contigs, truth, genome))
    return rec


# ---- device phases -----------------------------------------------------


def device_report():
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {d.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devs)}")
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def peak_bytes():
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def phase_compile(cfg):
    import jax
    import jax.numpy as jnp

    from faucet_tpu.core import scan as SC
    from faucet_tpu.pipeline import Pipeline

    p = Pipeline(cfg)
    B, L, P = cfg.batch_reads, cfg.max_read_length, cfg.positions_per_read
    trav = jax.eval_shape(lambda: SC.make_traversals(cfg))
    bases = jax.ShapeDtypeStruct((B, L), jnp.uint8)
    lens = jax.ShapeDtypeStruct((B,), jnp.int32)
    ws = jax.ShapeDtypeStruct((B, P), jnp.bool_)
    tables = (p.cascade, p.junctions, p.sinks, bases, lens)
    steps = {
        "load": lambda: p._load_nodes.lower(
            p.cascade, p.node_cascade, bases, lens, cfg=cfg),
        "load+solid (stream)": lambda: p._load_nodes_s.lower(
            p.cascade, p.node_cascade, bases, lens, cfg=cfg),
        "scan": lambda: p._scan.lower(
            *tables, cfg=cfg, node_cascade=p.node_cascade,
            window_solid=None, jspool=p.jspool),
        "scan (stream)": lambda: p._scan.lower(
            *tables, cfg=cfg, node_cascade=p.node_cascade,
            window_solid=ws, jspool=p.jspool, traversals=trav),
        "spool flush": lambda: p._flush.lower(p.junctions, p.jspool,
                                              cfg=cfg),
    }
    for name, lower in steps.items():
        t0 = time.perf_counter()
        compiled = lower().compile()
        dt = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "alias_size_in_bytes", "temp_size_in_bytes",
                  "generated_code_size_in_bytes")
        log(f"compiled {name} in {dt:.2f} s; memory_analysis: "
            + json.dumps({f: getattr(ma, f, None) for f in fields}))


def _stream_two(cfg, batches, device):
    import jax

    from faucet_tpu.pipeline import Pipeline

    with jax.default_device(device):
        p = Pipeline(cfg)
        n_solid = [int(p.stream_step(b, l).n_solid) for b, l in batches]
        p.flush_junctions()
        state = {"A": p.cascade.a_bloom.words, "B": p.cascade.b_bloom.words,
                 "D": p.node_cascade.a_bloom.words,
                 "E": p.node_cascade.b_bloom.words,
                 "junctions": p.junctions, "sinks": p.sinks,
                 "traversals": p.traversals}
        placed = {d for leaf in jax.tree_util.tree_leaves(state)
                  for d in leaf.devices()}
        if placed != {device}:
            raise AssertionError(f"state on {placed}, wanted {device}")
        return jax.device_get(state), n_solid


def phase_gpu_equals_cpu(cfg, reads):
    import jax

    from faucet_tpu.pipeline import batch_iter

    batches = list(batch_iter(reads[:2 * cfg.batch_reads], cfg))
    t0 = time.perf_counter()
    gpu, gpu_solid = _stream_two(cfg, batches, jax.devices()[0])
    t1 = time.perf_counter()
    cpu, cpu_solid = _stream_two(cfg, batches, jax.devices("cpu")[0])
    t2 = time.perf_counter()
    log(f"two stream batches: gpu {t1 - t0:.2f} s, host cpu "
        f"{t2 - t1:.2f} s (both including compile)")
    same = jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(a, b)), gpu, cpu)
    bad = [jax.tree_util.keystr(path) for path, ok
           in jax.tree_util.tree_leaves_with_path(same) if not ok]
    if gpu_solid != cpu_solid:
        bad.append(f"n_solid gpu={gpu_solid} cpu={cpu_solid}")
    if bad:
        raise AssertionError(f"GPU and CPU differ in: {bad}")
    log(f"GPU == CPU bit for bit: filters A B D E, junction, sink and "
        f"traversal tables; n_solid={gpu_solid}; junctions="
        f"{int(gpu['junctions'].count)} sinks={int(gpu['sinks'].count)} "
        f"traversal rows={int(gpu['traversals'].count)}")


def phase_insert_paths(seed):
    """Triton atomicOr insert vs the XLA sort insert on a 64 MB filter."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from faucet_tpu.core import bloom as BL

    rng = np.random.default_rng(seed)
    n, log2_bits, n_hash = BATCH * (READ_LEN - K + 1), 29, 7
    khi = jnp.asarray(rng.integers(0, 1 << 30, n, dtype=np.uint32))
    klo = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                      .astype(np.uint32))
    mask = jnp.asarray(rng.random(n) < 0.9)
    block, h1r, h2 = BL._block_h1r_h2(khi, klo, log2_bits)
    block = jnp.where(mask, block, BL._SENTINEL)
    words = jnp.zeros((1 << (log2_bits - 5),), jnp.uint32)
    out, ms = {}, {}
    for name, fn in (("triton", BL._scatter_or_triton),
                     ("xla", BL._scatter_or_xla)):
        step = jax.jit(partial(fn, n_hash=n_hash))
        out[name] = jax.block_until_ready(step(words, block, h1r, h2))
        t0 = time.perf_counter()
        for _ in range(20):
            jax.block_until_ready(step(words, block, h1r, h2))
        ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    if not np.array_equal(np.asarray(out["triton"]), np.asarray(out["xla"])):
        raise AssertionError("Triton and XLA inserts differ")
    bits = int(jnp.sum(jax.lax.population_count(out["triton"])))
    log(f"Triton insert == XLA insert on a 64 MB filter ({int(mask.sum())} "
        f"keys x {n_hash} bits, {bits} bits set); per call, warm: "
        f"triton {ms['triton']:.3f} ms, xla {ms['xla']:.3f} ms")


class CompileClock:
    """Sums JAX's trace, lowering, compile and cache-load durations."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.total += duration


def run_cli(name, argv, clock, stdin_path=None):
    """faucet_tpu.cli.main in this process; stdin_path feeds fd 0
    through a pipe from `cat`, as a shell pipe would."""
    from faucet_tpu import cli
    from faucet_tpu.io import native as NV
    from faucet_tpu.io.fastq import read_seqs

    if not NV.available():
        raise AssertionError("the native C++ reader did not build")
    cat = saved = None
    if stdin_path is not None:
        cat = subprocess.Popen(["cat", stdin_path], stdout=subprocess.PIPE)
        saved = os.dup(0)
        os.dup2(cat.stdout.fileno(), 0)
        cat.stdout.close()
    c0 = clock.total
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        if cat is not None:
            os.dup2(saved, 0)
            os.close(saved)
            try:
                cat.wait(timeout=60)
            except subprocess.TimeoutExpired:
                cat.kill()
                cat.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{name}: cli.main returned {rc}")
    prefix = argv[argv.index("-file_prefix") + 1]
    with open(prefix + ".metrics.jsonl") as f:
        rec = [json.loads(line) for line in f][-1]
    contigs = list(read_seqs(prefix + ".fasta", False))
    log(f"{name}: wall {wall:.2f} s, compile {clock.total - c0:.2f} s, "
        f"phases {json.dumps(rec['timers_s'])}, "
        f"peak_bytes_in_use {peak_bytes()}, "
        f"reads_loaded {rec['counters'].get('reads_loaded')}, "
        f"contigs {len(contigs)}")
    return contigs


def gate(name, contigs, genome, truth):
    rec = quality(contigs, genome, truth)
    misses = [k for k, v in GATES.items() if not rec[k] >= v]
    log(f"{name} quality: {json.dumps(rec)}")
    if misses:
        raise AssertionError(f"{name}: quality gate missed {misses}")


# ---- four cards --------------------------------------------------------


def _contig_key(c):
    """Orientation-free key; circular contigs rotate to their least
    32-mer so no O(n^2) rotation search is needed."""
    from faucet_tpu.core.kmer import revcomp_seq

    if not c.circular:
        return min(c.seq, revcomp_seq(c.seq))

    def rot(s):
        w = s + s[:32]
        i = min(range(len(s)), key=lambda j: w[j:j + 32])
        return s[i:] + s[:i]

    return "circular:" + min(rot(c.seq), rot(revcomp_seq(c.seq)))


def phase_four(reads):
    import jax

    from faucet_tpu.dist.mesh import make_mesh
    from faucet_tpu.dist.sharded import ShardedPipeline
    from faucet_tpu.metrics import Metrics
    from faucet_tpu.pipeline import Pipeline, batch_iter

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(jax.devices())}")
    argv = cli_argv(os.path.join(WORK, "four"), os.devnull)
    cfg4 = config_of(argv + ["--n_shards", "4"])
    cfg1 = config_of(argv)
    results = {}
    for name, cfg, make in (
            ("one card", cfg1, lambda c, m: Pipeline(c, m)),
            ("sharded x4", cfg4,
             lambda c, m: ShardedPipeline(c, make_mesh(4), m))):
        m = Metrics()
        p = make(cfg, m)
        t0 = time.perf_counter()
        p.load_batches(batch_iter(reads, cfg))
        log(f"{name}: load done at {time.perf_counter() - t0:.2f} s")
        p.scan_batches(batch_iter(reads, cfg))
        log(f"{name}: scan done at {time.perf_counter() - t0:.2f} s")
        g = p.build()
        log(f"{name}: build done at {time.perf_counter() - t0:.2f} s")
        g = p.clean_graph(g)
        wall = time.perf_counter() - t0
        results[name] = sorted(_contig_key(g.contigs[i]) for i in g.live())
        log(f"{name}: wall {wall:.2f} s (including compile), phases "
            f"{json.dumps({k: round(v, 3) for k, v in m.timers.items()})}, "
            f"contigs {len(results[name])}, route_dropped "
            f"{m.counters.get('route_dropped', 0)}")
        if name == "sharded x4" and m.counters.get("route_dropped", 1):
            raise AssertionError("sharded routing dropped k-mers")
    if results["sharded x4"] != results["one card"]:
        raise AssertionError("sharded contigs differ from one-card contigs")
    log(f"sharded x4 contigs == one-card contigs "
        f"({len(results['one card'])})")


# ---- main --------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()

    import jax

    # a failed CUDA start-up must be an error, not a silent CPU run; the
    # host CPU platform stays available for the phase-3 comparison
    jax.config.update("jax_platforms", "cuda,cpu")
    from faucet_tpu.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    dev = device_report()
    os.makedirs(WORK, exist_ok=True)

    t0 = time.perf_counter()
    genome, reads = make_reads(args.seed)
    log(f"set-up: {len(genome)} bp genome, {len(reads)} reads simulated "
        f"in {time.perf_counter() - t0:.2f} s (seed {args.seed})")
    if args.four:
        phase_four(reads)
        print(json.dumps({"ok": True, "device": dev}), flush=True)
        return

    import multiprocessing as mp

    from faucet_tpu import simulate as SIM

    fastq = os.path.join(WORK, "reads.fq")
    SIM.write_fastq(fastq, reads)
    # the truth unitigs take minutes of host Python: a host-only worker
    # computes them while the device phases run
    pool = mp.get_context("spawn").Pool(1, initializer=_host_only)
    try:
        truth = pool.apply_async(truth_unitigs, (genome,))

        cfg = config_of(cli_argv(os.path.join(WORK, "stream")))
        log(f"config-1 sizes: A {cfg.bloom_a_bits >> 23} MB, "
            f"B {cfg.bloom_b_bits >> 23} MB, D {cfg.bloom_d_bits >> 23} MB, "
            f"E {cfg.bloom_e_bits >> 23} MB, junction slots "
            f"{cfg.junction_cap}, sink slots {cfg.sink_cap}")
        t0 = time.perf_counter()
        phase_compile(cfg)
        log(f"phase 2 (compile) {time.perf_counter() - t0:.2f} s")
        phase_gpu_equals_cpu(cfg, reads)
        phase_insert_paths(args.seed)

        clock = CompileClock()
        two = run_cli("two-pass CLI",
                      cli_argv(os.path.join(WORK, "twopass"), fastq), clock)
        truth = truth.get()
        gate("two-pass CLI", two, genome, truth)
        one = run_cli("stream CLI (stdin)",
                      cli_argv(os.path.join(WORK, "stream")), clock,
                      stdin_path=fastq)
        gate("stream CLI (stdin)", one, genome, truth)
    finally:
        pool.terminate()
        pool.join()
    os.remove(fastq)
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
