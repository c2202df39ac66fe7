"""core/scan.upsert_rounds: live lanes reach the fold in original order,
K per round, with padding lanes masked off and nothing dropped."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from faucet_tpu.core import scan as SC


def _record(mask, K, sync=None):
    """Fold that writes each round's (masked) payload, the lane index,
    into a buffer at round * K; returns (lanes seen, rounds, total)."""
    n = mask.shape[0]
    cap = n + 2 * K

    def fold(state, cm, ps):
        buf, r = state
        vals = jnp.where(cm, ps[0], -1)
        return jax.lax.dynamic_update_slice(buf, vals, (r * K,)), r + 1

    init = (jnp.full((cap,), -2, jnp.int32), jnp.zeros((), jnp.int32))
    (buf, rounds), total = jax.jit(
        lambda m: SC.upsert_rounds(m, K, (jnp.arange(n, dtype=jnp.int32),),
                                   fold, init, sync=sync))(jnp.asarray(mask))
    return np.asarray(buf), int(rounds), int(total)


@pytest.mark.parametrize("n,density", [(4096, 0.02), (4096, 0.0),
                                       (1 << 15, 0.5), (1 << 15, 1.0)])
def test_rounds_keep_lane_order(n, density):
    rng = np.random.default_rng(int(n * (1 + density)))
    mask = rng.random(n) < density
    K = 1024
    buf, rounds, total = _record(mask, K)
    live = np.nonzero(mask)[0]
    assert total == len(live)
    assert rounds == -(-len(live) // K)
    seen = buf[: rounds * K]
    np.testing.assert_array_equal(seen[: len(live)], live)
    assert (seen[len(live):] == -1).all()   # padding lanes masked off
    assert (buf[rounds * K:] == -2).all()   # no round beyond the last


def test_rounds_pad_ragged_tail_and_sync():
    """n not a multiple of K: the padded tail never replays an earlier
    round's lanes; a synced (raised) round count only adds empty rounds."""
    rng = np.random.default_rng(3)
    n, K = 8192 + 100, 256
    mask = rng.random(n) < 0.12
    mask[-50:] = True   # live lanes inside the ragged last block
    live = np.nonzero(mask)[0]
    need = -(-len(live) // K)
    buf, rounds, total = _record(mask, K, sync=lambda r: r + 1)
    assert total == len(live) and rounds == need + 1
    seen = buf[: rounds * K]
    np.testing.assert_array_equal(seen[: len(live)], live)
    assert (seen[len(live):] == -1).all()
