"""Pair-HMM realignment of SNP-candidate observations near indels.

longshot is a pair-HMM *realigner* (its whole point — the reference invokes
it at volcanosv-asm.py:75-80): instead of trusting the aligner's CIGAR
columns, each read is re-scored against the two candidate local haplotypes
(REF window vs ALT window) and the allele is read off the likelihood
ratio.  Raw mismatch pileups systematically miscall candidates adjacent to
indels in noisy reads — the aligner places the indel arbitrarily within a
homopolymer and the mismatch column shifts.

Batched design: all (site × covering-read) pairs are padded to fixed
(B, R) read-segment / (B, W) haplotype-window batches and scored by ONE
jitted affine-gap Viterbi kernel in log space — a lax.scan over read rows
with the delete-chain linear recurrence solved by a running prefix-max
(cummax) instead of a sequential column loop, so every row is pure VPU
work.  Free start/end gaps on the haplotype side (the window flanks are
arbitrary), read segment fully consumed.

The allele decision is sign(V_ref − V_alt) gated at `margin` nats;
|Δ| < margin → uninformative (allele 0), matching how longshot drops
ambiguous observations rather than guessing.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e9


@functools.partial(jax.jit, static_argnames=("W",))
def _viterbi_batch(segs, seg_lens, haps, *, W: int,
                   log_match, log_mis, log_ins, a_mm, a_gap, a_ext, a_back):
    """(B, R) read segments vs (B, W) hap windows → (B,) Viterbi scores.

    States: M (consume both), I (consume read), D (consume hap).  Start
    free in any hap column; end free at any hap column on the row where
    the segment length is reached."""
    B, R = segs.shape

    def emit(b):            # (B, W) match/mismatch emissions for read base b
        amb = (b[:, None] >= 4) | (haps >= 4)
        eq = b[:, None] == haps
        return jnp.where(amb, jnp.float32(np.log(0.25)),
                         jnp.where(eq, log_match, log_mis))

    cols = jnp.arange(W, dtype=jnp.float32)

    def row(carry, xs):
        m, i_, d, best = carry
        b, t = xs                       # read base column (B,), row index
        e = emit(b)
        prev = jnp.maximum(jnp.maximum(m + a_mm, i_ + a_back), d + a_back)
        shifted = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.float32), prev[:, :-1]], axis=1)
        m_new = e + shifted
        i_new = log_ins + jnp.maximum(m + a_gap, i_ + a_ext)
        # delete chain: d_new[j] = max_{j'<j} m_new[j'] + a_gap + (j-j'-1)·a_ext
        g = jnp.maximum.accumulate(m_new - cols[None, :] * a_ext, axis=1)
        d_new = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.float32),
             g[:, :-1] + a_gap + (cols[None, 1:] - 1) * a_ext], axis=1)
        done = (t + 1) == seg_lens
        rowmax = jnp.max(jnp.maximum(m_new, i_new), axis=1)
        best = jnp.where(done, jnp.maximum(best, rowmax), best)
        return (m_new, i_new, d_new, best), None

    m0 = jnp.zeros((B, W), jnp.float32)          # free start at any column
    i0 = jnp.full((B, W), NEG, jnp.float32)
    d0 = jnp.full((B, W), NEG, jnp.float32)
    best0 = jnp.where(seg_lens == 0, 0.0, NEG).astype(jnp.float32)
    (_, _, _, best), _ = jax.lax.scan(
        row, (m0, i0, d0, best0),
        (segs.T, jnp.arange(R, dtype=jnp.int32)))
    return best


class PairHmmParams:
    def __init__(self, error_rate: float):
        e = max(min(error_rate, 0.3), 1e-4)
        gap = max(e / 2, 1e-4)
        self.log_match = float(np.log1p(-e))
        self.log_mis = float(np.log(e / 3))
        self.log_ins = float(np.log(0.25))
        self.a_mm = float(np.log1p(-2 * gap))
        self.a_gap = float(np.log(gap))
        self.a_ext = float(np.log(0.3))
        self.a_back = float(np.log(0.7))


_BUCKET = 4096


def pairhmm_alleles(read_segs: np.ndarray, seg_lens: np.ndarray,
                    hap_ref: np.ndarray, hap_alt: np.ndarray,
                    error_rate: float, margin: float = 1.0) -> np.ndarray:
    """Per-pair allele from the REF-vs-ALT Viterbi log-likelihood ratio.

    read_segs (N, R) int8 codes (4 = pad/N), seg_lens (N,), hap_ref/hap_alt
    (N, W).  Returns (N,) int8: +1 ref, -1 alt, 0 uninformative."""
    N, R = read_segs.shape
    W = hap_ref.shape[1]
    p = PairHmmParams(error_rate)
    out = np.zeros(N, np.int8)
    for lo in range(0, N, _BUCKET):
        hi = min(lo + _BUCKET, N)
        pad = _BUCKET - (hi - lo)
        segs = np.pad(read_segs[lo:hi], ((0, pad), (0, 0)), constant_values=4)
        lens = np.pad(seg_lens[lo:hi], (0, pad))
        both_h = np.concatenate([np.pad(hap_ref[lo:hi], ((0, pad), (0, 0)),
                                        constant_values=4),
                                 np.pad(hap_alt[lo:hi], ((0, pad), (0, 0)),
                                        constant_values=4)])
        both_s = np.concatenate([segs, segs])
        both_l = np.concatenate([lens, lens])
        v = np.asarray(_viterbi_batch(
            jnp.asarray(both_s), jnp.asarray(both_l, jnp.int32),
            jnp.asarray(both_h), W=W,
            log_match=p.log_match, log_mis=p.log_mis, log_ins=p.log_ins,
            a_mm=p.a_mm, a_gap=p.a_gap, a_ext=p.a_ext, a_back=p.a_back))
        delta = v[:_BUCKET] - v[_BUCKET:]
        a = np.where(delta > margin, 1, np.where(delta < -margin, -1, 0))
        out[lo:hi] = a[:hi - lo].astype(np.int8)
    return out
