"""Assembly QC: coverage-mixture HMM classifying contig regions.

Replaces the reference's Flagger subsystem (SURVEY.md §2.2):
`Evaluate_Assembly.py` + `preprocess_flagger.sh` (map reads→contigs, compute
coverage) + the cromwell-run `hmm_flagger.c` coverage HMM (flagger-0.3.3),
whose states classify each window as **err** (~0× coverage), **dup**
(assembly duplication, ~0.5×), **hap** (correct haploid, ~1×), or
**collapsed** (two haplotypes collapsed onto one contig, ~2×).  Collapsed
components drive SD re-assembly (`General_Assembly_Workflow_SD.py` →
`Replace_Collapsed_Contigs.py`).

Batched design: the forward-backward/Viterbi recursions are `lax.scan` over
windows, vmapped over a padded batch of contigs — one compiled program for
the whole assembly instead of per-contig C processes under cromwell.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import QCConfig
from ..io.bam import BamRecord
from ..utils.logging import get_logger

log = get_logger("qc")

STATE_NAMES = ("err", "dup", "hap", "collapsed")
# state coverage means as multiples of the haploid coverage λ
STATE_MULT = np.array([0.05, 0.5, 1.0, 2.0])
STAY = 0.95                 # sticky transitions (hmm_flagger-style prior)


def state_mults(n_states: int) -> np.ndarray:
    """Multiplier ladder per QCConfig.n_states: 3 = err/hap/collapsed,
    4 = + dup (the hmm_flagger default), 5 = + a high-copy state."""
    table = {3: [0.05, 1.0, 2.0],
             4: [0.05, 0.5, 1.0, 2.0],
             5: [0.05, 0.5, 1.0, 2.0, 4.0]}
    return np.array(table[n_states])


def state_names(n_states: int) -> tuple[str, ...]:
    return {3: ("err", "hap", "collapsed"),
            4: STATE_NAMES,
            5: STATE_NAMES + ("high",)}[n_states]


def contig_coverage_windows(records: list[BamRecord],
                            contig_lengths: dict[str, int],
                            contig_names: list[str],
                            window: int = 1_000) -> dict[str, np.ndarray]:
    """Per-window mean read-depth for each contig from reads→contig
    alignments (preprocess_flagger.sh equivalent)."""
    diffs = {c: np.zeros(contig_lengths[c] + 1, np.int64)
             for c in contig_lengths}
    for r in records:
        if r.is_unmapped or r.is_secondary or r.ref_id < 0:
            continue
        name = contig_names[r.ref_id]
        d = diffs.get(name)
        if d is None:
            continue
        d[min(r.pos, len(d) - 1)] += 1
        d[min(r.reference_end, len(d) - 1)] -= 1
    out = {}
    for c, d in diffs.items():
        cov = np.cumsum(d[:-1])
        L = contig_lengths[c]
        n_win = max(1, (L + window - 1) // window)
        pad = n_win * window - L
        covp = np.concatenate([cov, np.zeros(pad)]) if pad else cov
        means = covp.reshape(n_win, window).mean(axis=1)
        if pad and n_win > 1:           # last partial window: true mean
            means[-1] = cov[(n_win - 1) * window:].mean()
        out[c] = means
    return out


def _log_poisson(cov: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """log P(cov | Poisson(lam)) up to the shared lgamma term (cancels in
    posteriors/Viterbi argmax).  cov (..., 1), lam (S,) → (..., S)."""
    lam = jnp.maximum(lam, 1e-3)
    return cov * jnp.log(lam) - lam


@dataclass
class CoverageHMM:
    """Sticky coverage HMM with (over)dispersed Poisson emissions.

    means: per-state emission means (fitted by fit_coverage_hmm, or fixed
    multiples of a λ estimate).  tau: dispersion index — emissions are
    tempered by 1/tau, the quasi-Poisson widening hmm_flagger fits for
    real coverage tracks (GC waves, mapping bias make var > mean)."""
    means: np.ndarray
    stay: float = STAY
    tau: float = 1.0

    @staticmethod
    def from_lambda(lam: float, n_states: int = 4,
                    stay: float = STAY) -> "CoverageHMM":
        return CoverageHMM(means=state_mults(n_states) * lam, stay=stay)

    @property
    def lam(self) -> float:
        """Haploid coverage = the mean of the 1.0-multiplier state."""
        mults = state_mults(len(self.means))
        return float(self.means[int(np.argmin(np.abs(mults - 1.0)))])

    def _params(self):
        S = len(self.means)
        means = jnp.asarray(self.means)
        logA = jnp.log(jnp.where(
            jnp.eye(S, dtype=bool), self.stay, (1 - self.stay) / (S - 1)))
        logpi = jnp.log(jnp.full((S,), 1.0 / S))
        return means, logA, logpi

    def viterbi(self, cov: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """cov (B, T) window coverages (padded), valid (B, T) mask.
        Returns (B, T) int8 state labels."""
        means, logA, logpi = self._params()
        emit = _log_poisson(jnp.asarray(cov)[..., None], means) / self.tau
        emit = jnp.where(jnp.asarray(valid)[..., None], emit, 0.0)

        def one(emit_bt):
            def step(carry, e):
                delta = carry
                scores = delta[:, None] + logA + e[None, :]
                ptr = jnp.argmax(scores, axis=0)
                return jnp.max(scores, axis=0), ptr

            delta0 = logpi + emit_bt[0]
            deltaT, ptrs = jax.lax.scan(step, delta0, emit_bt[1:])
            last = jnp.argmax(deltaT)

            def back(s, p):
                return p[s], p[s]

            _, states = jax.lax.scan(back, last, ptrs, reverse=True)
            return jnp.concatenate([states, jnp.array([last])])

        return np.asarray(jax.jit(jax.vmap(one))(emit)).astype(np.int8)

    def posteriors(self, cov: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Forward-backward state posteriors (B, T, S)."""
        means, logA, logpi = self._params()
        emit = _log_poisson(jnp.asarray(cov)[..., None], means) / self.tau
        emit = jnp.where(jnp.asarray(valid)[..., None], emit, 0.0)

        def one(emit_bt):
            def fstep(alpha, e):
                a = jax.nn.logsumexp(alpha[:, None] + logA, axis=0) + e
                return a, a

            a0 = logpi + emit_bt[0]
            _, alphas = jax.lax.scan(fstep, a0, emit_bt[1:])
            alphas = jnp.concatenate([a0[None], alphas])

            def bstep(beta, e):
                b = jax.nn.logsumexp(logA + (e + beta)[None, :], axis=1)
                return b, b

            bT = jnp.zeros_like(a0)
            _, betas = jax.lax.scan(bstep, bT, emit_bt[1:], reverse=True)
            betas = jnp.concatenate([betas, bT[None]])
            lp = alphas + betas
            return jax.nn.softmax(lp, axis=-1)

        return np.asarray(jax.jit(jax.vmap(one))(emit))


@dataclass
class FlaggerResult:
    states: dict[str, np.ndarray]          # contig → (n_windows,) int8
    collapsed: list[str]                   # contigs with a collapsed block
    lam: float
    window: int

    def blocks(self, contig: str, state: int) -> list[tuple[int, int]]:
        """[(start, end)] bp spans of `state` runs in one contig."""
        s = self.states[contig]
        out = []
        run = None
        for i, v in enumerate(s):
            if v == state and run is None:
                run = i
            elif v != state and run is not None:
                out.append((run * self.window, i * self.window))
                run = None
        if run is not None:
            out.append((run * self.window, len(s) * self.window))
        return out


def estimate_haploid_coverage(cov_all: np.ndarray) -> float:
    """λ from the coverage histogram mode over non-empty windows."""
    nz = cov_all[cov_all > 0.5]
    if len(nz) == 0:
        return 1.0
    return float(np.median(nz))


def fit_coverage_hmm(cov: np.ndarray, valid: np.ndarray,
                     cfg: QCConfig) -> CoverageHMM:
    """EM-fit the coverage mixture HMM (the hmm_flagger.c role: iterative
    component mean/dispersion fitting, not fixed multiples of a median).

    Per iteration (Baum-Welch E-step on device, M-step on host):
      * tied-λ ML update   λ = Σ_ts γ·c / Σ_ts γ·m_s  (Poisson means tied
        to the multiplier ladder — robust to λ mis-estimates)
      * free per-state mean refinement, clamped to ±40% of the tied
        skeleton and monotone (keeps state identities from swapping)
      * dispersion index   τ = Σ w·(c-μ)²/μ / Σ w  (quasi-Poisson
        overdispersion: GC waves / mapping bias make var > mean; τ widens
        every state so smooth coverage undulation stops flagging)
    Stops at max_iter or λ convergence (<0.5%)."""
    mults = state_mults(cfg.n_states)
    lam = estimate_haploid_coverage(cov[valid])
    hmm = CoverageHMM(means=mults * lam)
    for _ in range(max(cfg.max_iter, 0)):
        gamma = hmm.posteriors(cov, valid)                    # (B,T,S)
        w = gamma * valid[..., None]
        num = (w * cov[..., None]).sum(axis=(0, 1))           # Σ γ·c
        den = w.sum(axis=(0, 1))                              # Σ γ
        lam_new = float(num.sum() / max(float((den * mults).sum()), 1e-9))
        tied = np.maximum(mults * lam_new, 1e-2)
        free = num / np.maximum(den, 1e-9)
        means = np.clip(free, 0.6 * tied, 1.4 * tied)
        means = np.maximum.accumulate(np.maximum(means, 1e-2))
        disp = ((cov[..., None] - means) ** 2 / np.maximum(means, 1e-2))
        tau = float((w * disp).sum() / max(float(w.sum()), 1e-9))
        tau = float(np.clip(tau, 1.0, 10.0))
        converged = abs(lam_new - hmm.lam) <= 0.005 * max(hmm.lam, 1e-9)
        hmm = CoverageHMM(means=means, stay=hmm.stay, tau=tau)
        if converged:
            break
    return hmm


def evaluate_assembly(contigs: dict[str, str],
                      read_records: list[BamRecord],
                      contig_names: list[str],
                      cfg: QCConfig,
                      min_collapsed_windows: int = 2) -> FlaggerResult:
    """Classify every contig window; flag contigs containing collapsed
    blocks (Evaluate_Assembly.py:55-69 'Col' component grep equivalent).

    read_records: reads aligned TO THE CONTIGS (ref_id indexes
    contig_names)."""
    lens = {c: len(s) for c, s in contigs.items()}
    covs = contig_coverage_windows(read_records, lens, contig_names,
                                   cfg.window)
    names = list(covs)
    T = max((len(v) for v in covs.values()), default=1)
    B = len(names)
    cov = np.zeros((B, T))
    valid = np.zeros((B, T), bool)
    for i, c in enumerate(names):
        v = covs[c]
        cov[i, :len(v)] = v
        valid[i, :len(v)] = True
    if cfg.max_iter > 0:
        hmm = fit_coverage_hmm(cov, valid, cfg)
    else:                               # fixed multiples of the λ median
        hmm = CoverageHMM.from_lambda(
            estimate_haploid_coverage(cov[valid]), cfg.n_states)
    states = hmm.viterbi(cov, valid)
    collapsed_state = int(np.argmin(
        np.abs(state_mults(cfg.n_states) - 2.0)))
    result: dict[str, np.ndarray] = {}
    collapsed = []
    for i, c in enumerate(names):
        s = states[i, :len(covs[c])]
        result[c] = s
        if int((s == collapsed_state).sum()) >= min_collapsed_windows:
            collapsed.append(c)
    log.info("flagger: λ=%.1f τ=%.2f, %d/%d contigs with collapsed blocks",
             hmm.lam, hmm.tau, len(collapsed), len(names))
    return FlaggerResult(states=result, collapsed=collapsed, lam=hmm.lam,
                         window=cfg.window)
