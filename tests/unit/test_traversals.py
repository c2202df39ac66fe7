"""Single-pass streams count the slot traversals of every solid window
(core/scan.make_traversals) and hand each junction its stream-long counts
at build time (core/scan.junction_coverage)."""
import numpy as np
import jax.numpy as jnp
import pytest

from faucet_tpu import simulate
from faucet_tpu.config import Config
from faucet_tpu.core import scan as SC
from faucet_tpu.core import table as T
from faucet_tpu.graph.build import _to_int, extract_table
from faucet_tpu.pipeline import Pipeline, batch_iter


def _rows(tbl):
    t = extract_table(tbl)
    return {int(k): t["v0"][i] for i, k in enumerate(_to_int(t["hi"],
                                                             t["lo"]))}


@pytest.mark.parametrize("exact", [True, False])
def test_one_batch_junction_rows_equal_traversal_rows(exact):
    """Within one batch a junction window's table row and its traversal
    row count the same reads; the traversal table also holds every other
    solid window."""
    rng = np.random.default_rng(5)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    reads = simulate.shred(rng, genome, coverage=40, read_len=100,
                           err_rate=0.005, circular=True)
    cfg = Config(size_kmer=21, max_read_length=100, batch_reads=2048,
                 exact=exact, estimated_kmers=1 << 14, singletons=1 << 14,
                 junction_capacity=1 << 13, sink_capacity=1 << 13)
    p = Pipeline(cfg)
    (bases, lens), = batch_iter(reads, cfg)
    res = p.stream_step(bases, lens)
    p.flush_junctions()
    jrows, trows = _rows(p.junctions), _rows(p.traversals)
    assert jrows and set(jrows) <= set(trows)
    for key, cov8 in jrows.items():
        np.testing.assert_array_equal(trows[key], cov8)
    assert len(trows) > 10 * len(jrows)
    assert int(p.traversals.dropped) == 0
    assert sum(int(v.sum()) for v in trows.values()) <= 2 * int(res.n_solid)


def test_junction_coverage_replaces_found_rows_only():
    cfg = Config(size_kmer=31, max_read_length=100)
    jt = T.make(64, (((8,), jnp.int32), ((8,), jnp.uint16)))
    keys_hi = jnp.arange(1, 7, dtype=jnp.uint32)
    keys_lo = keys_hi * 7
    cov = jnp.ones((6, 8), jnp.int32)
    dist = jnp.full((6, 8), 9, jnp.uint16)
    jt = T.upsert(jt, keys_hi, keys_lo, (cov, dist), jnp.ones(6, bool),
                  modes=("add", "max"))
    tr = T.make(256, (((8,), jnp.int32),))
    # traversal rows for keys 2 and 5, and one key that is no junction
    thi = jnp.asarray([2, 5, 40], jnp.uint32)
    tcov = jnp.arange(24, dtype=jnp.int32).reshape(3, 8) + 10
    tr = T.upsert(tr, thi, thi * 7, (tcov,), jnp.ones(3, bool),
                  modes=("add",))
    out = SC.junction_coverage(jt, tr, cfg)
    t = extract_table(out)
    got = {int(h): (c, d) for h, c, d in zip(t["hi"], t["v0"], t["v1"])}
    assert sorted(got) == [1, 2, 3, 4, 5, 6]
    for h, (c, d) in got.items():
        want = {2: tcov[0], 5: tcov[1]}.get(h, np.ones(8, np.int32))
        np.testing.assert_array_equal(c, np.asarray(want))
        np.testing.assert_array_equal(d, np.full(8, 9, np.uint16))


def test_two_pass_makes_no_traversal_table():
    rng = np.random.default_rng(2)
    genome = simulate.random_genome(rng, 1500)
    reads = simulate.shred(rng, genome, coverage=20, read_len=100)
    cfg = Config(size_kmer=21, max_read_length=100, batch_reads=256,
                 estimated_kmers=1 << 12, singletons=1 << 12)
    p = Pipeline(cfg)
    p.load_reads(reads)
    p.scan_reads(reads)
    assert p.traversals is None
