"""Tagged branch-node keys: junction detection without 8-way probes.

Reference analogue: the scan's junction test — ">=2 of a k-mer's 4
single-base extensions are solid" (SURVEY.md §A.3, ref:src/ReadScanner.cpp
[C:high]). The reference answers it with up to 8 Bloom probes per
position; this module re-derives it from ONE auxiliary structure built
during the load pass, cutting the scan's probe volume ~3x (each probe
is a random row gather into a filter, so probe count drives the scan's
memory traffic).

Idea: in the bidirected de Bruijn graph, a solid k-mer (an edge) is
incident to two (k-1)-mer nodes, each at a specific SIDE. Writing o(n)=0
if the (k-1)-mer as seen is its own canonical form (else 1) and pos=0 for
a prefix occurrence / 1 for a suffix occurrence, the pair

    key(edge endpoint) = (canonical (k-1)-mer, pos XOR o)

is orientation-invariant: computing it from the k-mer's forward or
reverse-complement frame gives the same key. ">=2 solid extensions on a
window's right" is then exactly ">=2 distinct solid edges carry endpoint
key (suffix-node(w), o(suffix-node(w)))" — a membership question.

During the load pass, each k-mer first promoted into solid filter B
(new_b from core/bloom.cascade_insert_nbs) inserts its two endpoint
keys into a second cascade D->E (same Cascade machinery: Bloom pair, or
exact tables in golden mode). E then holds exactly the branching
node-sides, and the scan's junction test becomes TWO E-probes per window
instead of eight B-probes. In exact mode this is provably the same
junction set; in Bloom mode E's fp adds rare spurious junctions (cleaned
like the reference's own Bloom-fp junctions) and a k-mer whose first
promotion was shadowed by a B false positive can go unrecorded (~fp_b of
junction edges; walks then retire on the ambiguity instead of merging,
SURVEY.md §3.5).

(k-1) is even, so palindromic nodes exist; their side bit is ambiguous,
and both insert and probe force side=0 for them, merging the two sides
(junction over-detection only, vanishing rate ~4^-(k-1)/2).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from faucet_tpu.core import u32x2 as u2

U32 = jnp.uint32
SIDE_BIT = np.uint32(30)  # tag bit in key_hi; code bits stay below 2*31-32


def _node_views(chi, clo, ohi, olo, k: int):
    """Both (k-1)-nodes of a k-mer given its canonical (chi,clo) and
    reverse-complement (ohi,olo) codes.

    Returns (prefix_fwd, prefix_rc, suffix_fwd, suffix_rc), each an
    (hi, lo) pair, all as seen in the k-mer's canonical frame."""
    nb = 2 * (k - 1)
    p_fwd = u2.shr2(chi, clo)
    p_rc = u2.mask_bits(ohi, olo, nb)
    s_fwd = u2.mask_bits(chi, clo, nb)
    s_rc = u2.shr2(ohi, olo)
    return p_fwd, p_rc, s_fwd, s_rc


def _tagged(n_fwd, n_rc, pos_is_suffix: bool):
    """Orientation-invariant endpoint key for a node occurrence."""
    fh, fl = n_fwd
    rh, rl = n_rc
    as_canon = u2.le(fh, fl, rh, rl)   # o = 0 when as-seen is canonical
    pal = u2.eq(fh, fl, rh, rl)
    khi, klo = u2.select(as_canon, fh, fl, rh, rl)
    o = jnp.logical_not(as_canon)
    side = (o ^ bool(pos_is_suffix)) & ~pal  # palindromes: force side 0
    return khi | (side.astype(U32) << SIDE_BIT), klo


def endpoint_keys(chi, clo, ohi, olo, k: int
                  ) -> Tuple[jnp.ndarray, jnp.ndarray,
                             jnp.ndarray, jnp.ndarray]:
    """The two endpoint keys a solid k-mer contributes on promotion.

    Returns (pk_hi, pk_lo, sk_hi, sk_lo): prefix-node endpoint (pos=0)
    and suffix-node endpoint (pos=1)."""
    p_fwd, p_rc, s_fwd, s_rc = _node_views(chi, clo, ohi, olo, k)
    pk_hi, pk_lo = _tagged(p_fwd, p_rc, pos_is_suffix=False)
    sk_hi, sk_lo = _tagged(s_fwd, s_rc, pos_is_suffix=True)
    return pk_hi, pk_lo, sk_hi, sk_lo


def probe_keys(chi, clo, ohi, olo, k: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray,
                          jnp.ndarray, jnp.ndarray]:
    """The two branch queries of a window.

    right-branch: out-edges of the window's suffix node — those edges see
    the node as their PREFIX, so the query key uses pos=0 at the suffix
    node. left-branch: in-edges of the prefix node — edges see it as
    their SUFFIX (pos=1).

    Returns (rk_hi, rk_lo, lk_hi, lk_lo)."""
    p_fwd, p_rc, s_fwd, s_rc = _node_views(chi, clo, ohi, olo, k)
    rk_hi, rk_lo = _tagged(s_fwd, s_rc, pos_is_suffix=False)
    lk_hi, lk_lo = _tagged(p_fwd, p_rc, pos_is_suffix=True)
    return rk_hi, rk_lo, lk_hi, lk_lo
