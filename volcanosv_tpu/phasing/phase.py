"""Read-backed phasing: MEC (minimum error correction) via alternating
majority votes — a batched, fixed-shape core of what longshot/HapCUT2 do.

Model: each het SNP s has phase h[s] ∈ {+1,-1} (which haplotype carries the
alt allele); each read r has assignment a[r] ∈ {+1,-1}.  Observation
(r, s, o) with o=+1 (ref) or -1 (alt) is *consistent* when a[r]·h[s]·o = +1
(conventions fixed so hap +1 carries ref at h=+1 sites).  Alternating
updates

    a[r] = sign( Σ_obs(r) h[s]·o )        (read majority vote)
    h[s] = sign( Σ_obs(s) a[r]·o )        (SNP majority vote)

monotonically decrease the MEC objective; both are segment-sums over the
observation list — pure device ops (jax.ops.segment_sum), no Python loop
over reads/SNPs.  Restarts with different random inits escape local optima
(cheap: everything is batched over restarts too).

Phase blocks: consecutive het SNPs stay in one block iff some read covers
both (connectivity sweep); per-block sign is arbitrary, as in any phaser.

ref comparison: longshot (Rust, ~10k LoC) — invoked volcanosv-asm.py:75-80;
phase-block and HP/PS semantics follow prepare_info_v1.py:42-85.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PhasingConfig
from .pileup import PileupResult


def chain_init(obs_read: np.ndarray, obs_snp: np.ndarray,
               obs_allele: np.ndarray, n_snps: int) -> np.ndarray:
    """Phase init by chain propagation: for consecutive SNPs observed on the
    same read, vote on whether they share a haplotype (o_i·o_j), then take
    the prefix product of vote signs.  Near-exact for SNP chains — the
    alternating MEC pass then heals residual errors."""
    votes = np.zeros(max(n_snps - 1, 0), np.int64)
    order = np.lexsort((obs_snp, obs_read))
    r, s, o = obs_read[order], obs_snp[order], obs_allele[order].astype(np.int64)
    same_read = r[1:] == r[:-1]
    informative = (o[1:] != 0) & (o[:-1] != 0) & same_read
    # vote between s[i] and s[i+1]: sign(o_i*o_j); accumulate at the left
    # SNP of each adjacent pair (pairs may skip SNPs; propagation still
    # anchors where coverage exists)
    left = np.minimum(s[:-1], s[1:])[informative]
    sign = (o[1:] * o[:-1])[informative]
    np.add.at(votes, np.clip(left, 0, n_snps - 2), sign)
    rel = np.where(votes >= 0, 1, -1)
    h = np.ones(n_snps, np.int64)
    if n_snps > 1:
        h[1:] = np.cumprod(rel)
    return h.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("n_reads", "n_snps", "n_iter",
                                             "n_restarts"))
def _mec_phase(obs_read, obs_snp, obs_allele, h_init, key, *, n_reads: int,
               n_snps: int, n_iter: int, n_restarts: int):
    """Batched alternating majority votes.  Returns (h, a, mec) of the best
    restart: h (n_snps,) ±1, a (n_reads,) ±1, mec scalar.  h_init seeds
    restart 0 (chain init); the rest are random."""
    o = obs_allele.astype(jnp.int32)

    def run(key, h0, use_h0):
        h = jnp.where(use_h0, h0,
                      jax.random.rademacher(key, (n_snps,), jnp.int32))

        def step(h, _):
            va = jax.ops.segment_sum(h[obs_snp] * o, obs_read,
                                     num_segments=n_reads)
            a = jnp.where(va >= 0, 1, -1)
            vh = jax.ops.segment_sum(a[obs_read] * o, obs_snp,
                                     num_segments=n_snps)
            h2 = jnp.where(vh >= 0, 1, -1)
            return h2, None

        h, _ = jax.lax.scan(step, h, None, length=n_iter)
        va = jax.ops.segment_sum(h[obs_snp] * o, obs_read,
                                 num_segments=n_reads)
        a = jnp.where(va >= 0, 1, -1)
        # MEC = #observations inconsistent with (a, h)
        consistent = a[obs_read] * h[obs_snp] * o
        mec = jnp.sum((consistent < 0) & (o != 0))
        return h, a, mec

    keys = jax.random.split(key, n_restarts)
    use_h0 = jnp.arange(n_restarts) == 0
    hs, as_, mecs = jax.vmap(run, in_axes=(0, None, 0))(keys, h_init, use_h0)
    best = jnp.argmin(mecs)
    return hs[best], as_[best], mecs[best]


@dataclass
class PhaseResult:
    snp_pos: np.ndarray         # (S,) het SNP positions (0-based)
    ref_base: np.ndarray
    alt_base: np.ndarray
    phase: np.ndarray           # (S,) ±1: +1 → hap1 carries REF (GT 0|1)
    block_id: np.ndarray        # (S,) int64 phase-set id = block start pos+1
    read_hap: np.ndarray        # (R,) int8 0=unassigned, 1, 2
    read_block: np.ndarray      # (R,) int64 block id or -1
    read_names: list[str]
    mec: int
    # hom-alt (unphased) sites for the SNP VCF
    hom_pos: np.ndarray
    hom_ref: np.ndarray
    hom_alt: np.ndarray
    # SV-marker columns (pileup.PileupResult.marker): phased like SNPs but
    # excluded from the SNP VCF output
    marker: np.ndarray = None   # (S,) bool over snp_pos

    def blocks(self) -> list[tuple[int, int, int]]:
        """[(block_id, start_pos, end_pos)] (0-based inclusive span)."""
        out = []
        for b in np.unique(self.block_id):
            sel = self.block_id == b
            p = self.snp_pos[sel]
            out.append((int(b), int(p.min()), int(p.max())))
        return out


def phase_chromosome(pile: PileupResult, cfg: PhasingConfig,
                     seed: int = 0, n_restarts: int = 8) -> PhaseResult:
    """Phase the het candidates of one chromosome's pileup."""
    het_idx = np.nonzero(pile.is_het)[0]
    hom_sel = ~pile.is_het
    n_reads = len(pile.read_names)
    pile_marker = pile.marker if pile.marker is not None \
        else np.zeros(len(pile.snp_pos), bool)
    if len(het_idx) == 0 or n_reads == 0:
        return PhaseResult(
            np.zeros(0, np.int64), np.zeros(0, np.int8), np.zeros(0, np.int8),
            np.zeros(0, np.int8), np.zeros(0, np.int64),
            np.zeros(n_reads, np.int8), np.full(n_reads, -1, np.int64),
            pile.read_names, 0, pile.snp_pos[hom_sel],
            pile.ref_base[hom_sel], pile.alt_base[hom_sel],
            marker=np.zeros(0, bool))

    # compress obs to het sites
    remap = np.full(len(pile.snp_pos), -1, np.int64)
    remap[het_idx] = np.arange(len(het_idx))
    keep = remap[pile.obs_snp] >= 0
    obs_read = pile.obs_read[keep]
    obs_snp = remap[pile.obs_snp[keep]].astype(np.int32)
    obs_allele = pile.obs_allele[keep]
    S = len(het_idx)

    h0 = chain_init(obs_read, obs_snp, obs_allele, S)
    h, a, mec = _mec_phase(
        jnp.asarray(obs_read), jnp.asarray(obs_snp), jnp.asarray(obs_allele),
        jnp.asarray(h0), jax.random.PRNGKey(seed), n_reads=n_reads, n_snps=S,
        n_iter=cfg.max_phase_iter, n_restarts=n_restarts)
    h = np.asarray(h)
    a = np.asarray(a)

    # self-healing pass: an SV marker column whose observations fight the
    # SNP-derived solution (alignment-representation lottery — the event
    # surfaces in only some carriers' CIGARs) contributes concentrated MEC
    # at its own site.  Null its obs and re-solve; SNP columns stay.
    site_marker = pile_marker[het_idx]
    if site_marker.any() and len(obs_read):
        cons = a[obs_read] * h[obs_snp] * obs_allele
        informative = obs_allele != 0
        bad = np.bincount(obs_snp[informative & (cons < 0)], minlength=S)
        tot = np.bincount(obs_snp[informative], minlength=S)
        poison = site_marker & (tot >= 4) & (bad > 0.15 * tot)
        if poison.any():
            keep_o = ~poison[obs_snp]
            obs_read2 = obs_read[keep_o]
            obs_snp2 = obs_snp[keep_o]
            obs_allele2 = obs_allele[keep_o]
            if len(obs_read2):
                h0 = chain_init(obs_read2, obs_snp2, obs_allele2, S)
                h, a, mec = _mec_phase(
                    jnp.asarray(obs_read2), jnp.asarray(obs_snp2),
                    jnp.asarray(obs_allele2), jnp.asarray(h0),
                    jax.random.PRNGKey(seed), n_reads=n_reads, n_snps=S,
                    n_iter=cfg.max_phase_iter, n_restarts=n_restarts)
                h = np.asarray(h)
                a = np.asarray(a)
                obs_read, obs_snp, obs_allele = (obs_read2, obs_snp2,
                                                 obs_allele2)

    # phase blocks: SNP i and i+1 connected iff some read observes both
    # (per-read [min,max] snp interval overlay)
    link = np.zeros(max(S - 1, 0), bool)
    if S > 1 and len(obs_snp):
        order = np.argsort(obs_read, kind="stable")
        ord_r, ord_s = obs_read[order], obs_snp[order]
        first = np.concatenate([[True], ord_r[1:] != ord_r[:-1]])
        starts = np.nonzero(first)[0]
        ends = np.concatenate([starts[1:], [len(ord_r)]])
        lo = np.minimum.reduceat(ord_s, starts)
        hi = np.maximum.reduceat(ord_s, starts)
        d = np.zeros(S, np.int64)
        has = hi > lo
        np.add.at(d, lo[has], 1)
        np.add.at(d, hi[has], -1)
        link = np.cumsum(d)[:-1] > 0
    # linkage-consistency split (the longshot/HapCUT2 block contract): a
    # junction where the solved phase runs AGAINST the read linkage — or
    # where net consistent linkage is thin — is a potential switch point.
    # One mid-block switch error is invisible to the SNP-level solution
    # (both sides are internally consistent) but flips the haplotype label
    # of every read beyond it, which poisons the per-(block, hap) assembly
    # groups chromosome-wide once blocks span whole chromosomes.  Splitting
    # there makes the two sides independent blocks, where the label flip
    # is absorbed by per-block sign freedom.
    if S > 1 and len(obs_snp):
        score_d = np.zeros(S, np.int64)
        order2 = np.lexsort((obs_snp, obs_read))
        r2 = obs_read[order2]
        s2 = obs_snp[order2]
        o2 = obs_allele[order2].astype(np.int64)
        same = r2[1:] == r2[:-1]
        inf2 = (o2[1:] != 0) & (o2[:-1] != 0) & same
        s_a = np.minimum(s2[:-1], s2[1:])[inf2]
        s_b = np.maximum(s2[:-1], s2[1:])[inf2]
        span = s_b > s_a
        s_a, s_b = s_a[span], s_b[span]
        rel_obs = (o2[1:] * o2[:-1])[inf2][span]
        rel_chosen = (h[s_a] * h[s_b]).astype(np.int64)
        consistent = rel_obs * rel_chosen          # ±1 per bridging pair
        np.add.at(score_d, s_a, consistent)
        np.add.at(score_d, s_b, -consistent)
        junction_score = np.cumsum(score_d)[:-1]
        link &= junction_score >= 2
    block_start = np.concatenate([[True], ~link])
    block_idx = np.cumsum(block_start) - 1
    pos_het = pile.snp_pos[het_idx]
    starts_pos = pos_het[block_start]
    block_id = starts_pos[block_idx] + 1     # PS = 1-based block start pos

    # read → haplotype + block (majority block among its observations).
    # Eligibility: a read whose ONLY evidence is a single NOISY SV-marker
    # column is a coin flip (measured 44% misassigned on the HiFi golden —
    # individually-noisy marker carrier/clean calls); such reads stay
    # unassigned and fall through to the k-mer partition vote.  A single
    # marker obs still counts when the column is CLEAN — its observations
    # near-unanimously agree with the solved phase (the het-SV-in-SNP-
    # desert case, where the marker is the only possible signal).
    read_hap = np.zeros(n_reads, np.int8)
    read_block = np.full(n_reads, -1, np.int64)
    if len(obs_read):
        informative = obs_allele != 0
        at_marker = site_marker[obs_snp]
        nm_count = np.bincount(obs_read[informative & ~at_marker],
                               minlength=n_reads)
        mk_count = np.bincount(obs_read[informative & at_marker],
                               minlength=n_reads)
        # NOTE a single-clean-marker exception (with or without a span-
        # based desert test) was tried and reverted: it costs ~3 het SVs
        # on the HiFi golden.  longshot itself phases nothing without an
        # SNV — in the reference, SNV-free reads are assigned by the
        # k-mer partition vote, and that is exactly where single-marker
        # reads fall through to (partition.partition_reads).
        eligible = (nm_count >= 1) | (mk_count >= 2)
        sel = informative & eligible[obs_read]
        r = obs_read[sel]
        b = block_id[obs_snp[sel]]
        # a read's block: the block of its first observation (reads rarely
        # span blocks — blocks break where no read spans)
        order = np.argsort(r, kind="stable")
        r_o, b_o = r[order], b[order]
        first = np.concatenate([[True], r_o[1:] != r_o[:-1]])
        read_block[r_o[first]] = b_o[first]
        covered = np.unique(r)
        read_hap[covered] = np.where(a[covered] > 0, 1, 2).astype(np.int8)

    return PhaseResult(
        snp_pos=pos_het, ref_base=pile.ref_base[het_idx],
        alt_base=pile.alt_base[het_idx], phase=h.astype(np.int8),
        block_id=block_id, read_hap=read_hap, read_block=read_block,
        read_names=pile.read_names, mec=int(mec),
        hom_pos=pile.snp_pos[hom_sel], hom_ref=pile.ref_base[hom_sel],
        hom_alt=pile.alt_base[hom_sel], marker=pile_marker[het_idx])
