"""CLI end-to-end tests: reference-style command lines, checkpoint/resume
(SURVEY.md §3.3, §5 "Config / flag system")."""
import os
import subprocess
import sys

import numpy as np
import pytest

from faucet_tpu import simulate
from faucet_tpu.core.kmer import revcomp_seq
from faucet_tpu.out.fasta import read_fasta


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run_cli(args, cwd, stdin_data=None):
    env = dict(os.environ)
    # make faucet_tpu importable; the platform is forced via --platform
    env["PYTHONPATH"] = env.get("PYTHONPATH", "") + os.pathsep + _REPO
    return subprocess.run(
        [sys.executable, "-m", "faucet_tpu.cli", "--platform", "cpu"]
        + args, cwd=cwd, env=env, capture_output=True, text=True,
        timeout=500, input=stdin_data)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(99)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    reads = simulate.shred(rng, genome, coverage=40, read_len=100,
                           circular=True)
    simulate.write_fasta(str(d / "reads.fa"), reads)
    simulate.write_fastq(str(d / "reads.fq"), reads)
    return d, genome


def _assert_genome_true(fasta_path, genome):
    doubled = genome + genome
    both = doubled + "#" + revcomp_seq(doubled)
    n = 0
    for name, seq in read_fasta(fasta_path):
        assert seq in both or revcomp_seq(seq) in both
        n += 1
    assert n >= 1


def test_cli_two_pass_and_resume(workdir):
    d, genome = workdir
    r = _run_cli(["-read_load_file", "reads.fa", "-read_scan_file",
                  "reads.fa", "-size_kmer", "21", "-max_read_length", "100",
                  "-estimated_kmers", str(1 << 15), "-singletons",
                  str(1 << 15), "-file_prefix", "out", "--batch_reads",
                  "256", "--metrics_file", "m.jsonl"], cwd=str(d))
    assert r.returncode == 0, r.stderr[-2000:]
    assert (d / "out.fasta").exists() and (d / "out.gfa").exists()
    assert (d / "out.bloom.npz").exists()
    assert (d / "out.junctions.npz").exists()
    assert (d / "m.jsonl").exists()
    _assert_genome_true(str(d / "out.fasta"), genome)

    # resume from checkpoint: skip both stream passes
    r2 = _run_cli(["-bloom_file", "out.bloom.npz", "-junctions_file",
                   "out.junctions.npz", "-size_kmer", "21",
                   "-max_read_length", "100", "-estimated_kmers",
                   str(1 << 15), "-singletons", str(1 << 15),
                   "-file_prefix", "out2", "--batch_reads", "256"],
                  cwd=str(d))
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed" in r2.stderr
    a = sorted(s for _, s in read_fasta(str(d / "out.fasta")))
    b = sorted(s for _, s in read_fasta(str(d / "out2.fasta")))
    assert a == b, "resume must reproduce the assembly bit-identically"


def test_cli_fastq_stream_mode(workdir):
    d, genome = workdir
    r = _run_cli(["-read_load_file", "reads.fq", "--fastq", "--stream",
                  "-size_kmer", "21", "-max_read_length", "100",
                  "-estimated_kmers", str(1 << 15), "-singletons",
                  str(1 << 15), "-file_prefix", "outs", "--batch_reads",
                  "256"], cwd=str(d))
    assert r.returncode == 0, r.stderr[-2000:]
    # the streaming path must ride the native C++ reader (VERDICT r2 #7)
    assert "using native C++ reader" in r.stderr
    _assert_genome_true(str(d / "outs.fasta"), genome)


def test_cli_stream_from_stdin_pipe(workdir):
    """The reference's signature mode: reads arrive on a pipe, one pass
    (SURVEY.md §0.5 'streaming'); native reader reads fd 0."""
    d, genome = workdir
    data = (d / "reads.fa").read_text()
    r = _run_cli(["-read_load_file", "-", "--stream", "-size_kmer", "21",
                  "-max_read_length", "100", "-estimated_kmers",
                  str(1 << 15), "-singletons", str(1 << 15),
                  "-file_prefix", "outp", "--batch_reads", "256"],
                 cwd=str(d), stdin_data=data)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "using native C++ reader" in r.stderr
    _assert_genome_true(str(d / "outp.fasta"), genome)


def test_cli_paired_native_reader(workdir):
    """--paired_ends now rides the native reader too (VERDICT r2 #7):
    interleaved mates = alternating rows of each packed batch."""
    d, genome = workdir
    rng = np.random.default_rng(5)
    m1, m2 = simulate.shred(rng, genome, coverage=40, read_len=100,
                            circular=True, paired=True, insert=300)
    inter = [x for ab in zip(m1, m2) for x in ab]
    simulate.write_fasta(str(d / "paired.fa"), inter)
    r = _run_cli(["-read_load_file", "paired.fa", "-read_scan_file",
                  "paired.fa", "--paired_ends", "-size_kmer", "21",
                  "-max_read_length", "100", "-estimated_kmers",
                  str(1 << 15), "-singletons", str(1 << 15),
                  "-file_prefix", "outpe", "--batch_reads", "256"],
                 cwd=str(d))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "using native C++ reader" in r.stderr
    assert "pair_batches" in r.stderr
    _assert_genome_true(str(d / "outpe.fasta"), genome)


def test_cli_dual_k_from_stdin_spools(workdir):
    """dual-k needs two passes; on a pipe the load reads are spooled to a
    temp file instead of failing (VERDICT r2 weak #7)."""
    d, genome = workdir
    data = (d / "reads.fa").read_text()
    r = _run_cli(["-read_load_file", "-", "-read_scan_file", "reads.fa",
                  "-size_kmer", "17", "-second_kmer", "25",
                  "-max_read_length", "100", "-estimated_kmers",
                  str(1 << 15), "-singletons", str(1 << 15),
                  "-file_prefix", "outdk", "--batch_reads", "256"],
                 cwd=str(d), stdin_data=data)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "spooled load reads" in r.stderr
    assert "dual-k second pass" in r.stderr
    _assert_genome_true(str(d / "outdk.fasta"), genome)


def test_cli_errors(workdir):
    d, _ = workdir
    r = _run_cli(["-size_kmer", "21"], cwd=str(d))
    assert r.returncode == 2
    assert "need -read_load_file" in r.stderr
    r = _run_cli(["-bloom_file", "out.bloom.npz", "-size_kmer", "21"],
                 cwd=str(d))
    assert r.returncode == 2
    assert "both" in r.stderr
    # resume with mismatched parameters must refuse
    r = _run_cli(["-bloom_file", "out.bloom.npz", "-junctions_file",
                  "out.junctions.npz", "-size_kmer", "23",
                  "-max_read_length", "100", "-estimated_kmers",
                  str(1 << 15), "-singletons", str(1 << 15),
                  "-file_prefix", "bad"], cwd=str(d))
    assert r.returncode != 0
    assert "different k-mer/filter parameters" in (r.stderr + r.stdout)
