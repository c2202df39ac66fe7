"""Sharded pipeline equivalence on the virtual 8-device CPU mesh
(SURVEY.md §4 "multi-device without a cluster").

The strongest property the owner-prefixed address design buys: the
global arrays of the 8-shard pipeline must be BIT-IDENTICAL to the
single-device pipeline's arrays under the same config — sharding is
"just" a split of the same layout plus routing.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from faucet_tpu import simulate
from faucet_tpu.config import Config
from faucet_tpu.core.kmer import revcomp_seq
from faucet_tpu.dist.mesh import make_mesh
from faucet_tpu.dist.sharded import ShardedPipeline
from faucet_tpu.pipeline import Pipeline

K = 21
S = 8


def _cfg(exact, **kw):
    base = dict(size_kmer=K, max_read_length=100, batch_reads=64,
                exact=exact, n_shards=S, estimated_kmers=1 << 14,
                singletons=1 << 14, junction_capacity=1 << 13,
                sink_capacity=1 << 14, fp_rate=0.002)
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(2024)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    reads = simulate.shred(rng, genome, coverage=40, read_len=100,
                           circular=True)
    return genome, reads


@pytest.mark.parametrize("exact", [True, False])
def test_sharded_bit_identical_to_single_device(case, exact):
    genome, reads = case
    assert len(jax.devices()) >= S, "conftest must provide 8 CPU devices"
    cfg = _cfg(exact)

    sp = ShardedPipeline(cfg, make_mesh(S))
    sp.load_reads(reads)
    sp.scan_reads(reads)
    assert sp.metrics.counters.get("route_dropped", 0) == 0

    p = Pipeline(cfg)
    p.load_reads(reads)
    p.scan_reads(reads)

    if exact:
        np.testing.assert_array_equal(
            np.asarray(sp.cascade.b_table.keys_hi),
            np.asarray(p.cascade.b_table.keys_hi))
        np.testing.assert_array_equal(
            np.asarray(sp.cascade.b_table.keys_lo),
            np.asarray(p.cascade.b_table.keys_lo))
    else:
        np.testing.assert_array_equal(np.asarray(sp.cascade.a_bloom.words),
                                      np.asarray(p.cascade.a_bloom.words))
        np.testing.assert_array_equal(np.asarray(sp.cascade.b_bloom.words),
                                      np.asarray(p.cascade.b_bloom.words))
    np.testing.assert_array_equal(np.asarray(sp.junctions.keys_hi),
                                  np.asarray(p.junctions.keys_hi))
    np.testing.assert_array_equal(np.asarray(sp.junctions.vals[0]),
                                  np.asarray(p.junctions.vals[0]))
    np.testing.assert_array_equal(np.asarray(sp.junctions.vals[1]),
                                  np.asarray(p.junctions.vals[1]))
    np.testing.assert_array_equal(np.asarray(sp.sinks.keys_hi),
                                  np.asarray(p.sinks.keys_hi))
    np.testing.assert_array_equal(np.asarray(sp.sinks.vals[0]),
                                  np.asarray(p.sinks.vals[0]))

    # graph build runs unchanged on the sharded global arrays
    g_s = sp.build()
    g_1 = p.build()
    keys_s = sorted(g_s.contigs[i].canonical_seq() for i in g_s.live())
    keys_1 = sorted(g_1.contigs[i].canonical_seq() for i in g_1.live())
    assert keys_s == keys_1

    g_s = sp.clean_graph(g_s)
    doubled = genome + genome
    both = doubled + "#" + revcomp_seq(doubled)
    for i in g_s.live():
        c = g_s.contigs[i]
        s = c.seq if not c.circular else c.seq + c.seq[: K - 1]
        assert s in both


def test_sharded_stream_traversals_bit_identical(case):
    """Single-pass streams also count every solid window's slot
    traversals; sharded, those route to the owner shard and the global
    traversal table equals the single-device one, as do the junction
    coverages taken from it at build time."""
    genome, reads = case
    from faucet_tpu.pipeline import batch_iter

    cfg = _cfg(False)
    sp = ShardedPipeline(cfg, make_mesh(S))
    p = Pipeline(cfg)
    sp._start_stream()
    p._start_stream()
    for bases, lens in batch_iter(reads, cfg):
        for q in (sp, p):
            q.load_batch(bases, lens)
            q.scan_batch(bases, lens)
    p.flush_junctions()
    assert sp.metrics.counters.get("route_dropped", 0) == 0
    for a, b in ((sp.traversals.keys_hi, p.traversals.keys_hi),
                 (sp.traversals.keys_lo, p.traversals.keys_lo),
                 (sp.traversals.vals[0], p.traversals.vals[0])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(np.asarray(p.traversals.count)) > 0

    g_s, g_1 = sp.build(), p.build()
    np.testing.assert_array_equal(np.asarray(sp.junctions.vals[0]),
                                  np.asarray(p.junctions.vals[0]))
    keys_s = sorted(g_s.contigs[i].canonical_seq() for i in g_s.live())
    keys_1 = sorted(g_1.contigs[i].canonical_seq() for i in g_1.live())
    assert keys_s == keys_1
    assert sp.traversals is None and p.traversals is None
