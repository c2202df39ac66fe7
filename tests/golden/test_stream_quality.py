"""Single-pass streaming at realistic per-batch depth: junctions found
late in the stream (a doubled error becomes solid when its second copy
arrives) must still get their whole-stream slot coverage, or cleaning
misjudges their arms and the assembly fragments."""
import numpy as np

from faucet_tpu import simulate
from faucet_tpu.config import Config
from faucet_tpu.core.kmer import revcomp_seq
from faucet_tpu.pipeline import Pipeline
from refimpl.unitigs import genome_graph

K = 31


def test_stream_recovers_every_truth_unitig():
    rng = np.random.default_rng(0)
    genome = simulate.genome_with_repeats(rng, 60_000, n_repeats=4,
                                          repeat_len=400)
    # 50x in 30 batches: under 2x of depth per batch
    reads = simulate.shred(rng, genome, coverage=50, read_len=100,
                           err_rate=0.005, circular=True)
    cfg = Config(size_kmer=K, max_read_length=100, batch_reads=1024,
                 estimated_kmers=60_000, singletons=300_000)
    g = Pipeline(cfg).run_streaming(reads)
    contigs = [g.contigs[i].seq for i in g.live()]
    tg = genome_graph(genome, K, circular=True)
    truth = [tg.contigs[i].seq for i in tg.live()]
    hay = "#".join(contigs)
    hay += "#" + revcomp_seq(hay)
    assert [t for t in truth if t not in hay] == []
    assert len(contigs) == len(truth)
    doubled = genome + genome
    both = doubled + "#" + revcomp_seq(doubled)
    assert all(c in both for c in contigs)
