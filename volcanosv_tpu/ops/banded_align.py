"""Banded affine-gap alignment — the DP core of the whole engine.

This one kernel family replaces every alignment engine the reference shells
out to (SURVEY.md §2.2):
  * minimap2 extension DP   (contig→ref asm5/asm10/asm20, reads→ref map-*)
  * hifiasm/flye overlap DP (read-vs-read, ava mode)
  * edlib edit distance     (remove_redundancy.py:75-81, svim-asm pairing)
  * htsbox pileup's implicit per-read alignment reuse

Design:
  The band is fixed in *diagonal* space: lanes l ∈ [0,W) map to diagonals
  d = j - i = d_lo + l.  Per query row i the target window T[i+d_lo : i+d_lo+W)
  shifts by exactly one, identical across the batch, so hundreds of
  alignments run in lockstep as (B, W) vectors.  Vertical gaps read the
  previous row at lane l+1 (pure shift); horizontal gaps within a row are
  resolved exactly with a max-plus prefix scan (the affine F-recurrence
  F[l] = go + ge·l + max_{s<l}(Htmp[s] − ge·s)).

  Two implementations share these semantics — identical scores, end
  columns, diagonal-0 profiles and CIGARs — and `dp_kernel` picks one per
  platform:
    * `banded_align_scan` — pure JAX lax.scan; the CPU path and the
      correctness oracle
    * `ops.gpu` — the Hopper kernel (CUDA through the XLA FFI): one warp
      per alignment with the band in registers

  Traceback is exact: 1 byte/cell (H-choice + E/F gap-open flags) in an
  (M, B, W) tensor that is walked on the device; only the packed op
  stream reaches the host.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

# plain python int (not jnp.int32): a device constant at import time would
# initialize the backend and break jax.distributed.initialize ordering for
# multi-host runs; jnp promotes it inside traced code identically
NEG = -(10**9) // 2

# traceback encoding: bits 0-2 = H source, bits 3-6 = gap-open flags
TB_DIAG, TB_UP, TB_LEFT = 0, 1, 2
TB_UP2, TB_LEFT2 = 3, 4                      # long-gap (dual-affine) states
TB_CHOICE = 7
TB_E_OPEN = 8                                # E opened (vs extended)
TB_F_OPEN = 16                               # F opened (vs extended)
TB_E2_OPEN = 32
TB_F2_OPEN = 64


@dataclass(frozen=True)
class Scores:
    """Affine (optionally dual-affine) gap scores.

    gap_open is charged on open *in addition to* extend.  gap_open2/
    gap_extend2 enable the second (long-gap) affine class: gap cost =
    max(open+k·ext, open2+k·ext2) in score space — minimap2's -O o1,o2
    -E e1,e2 double affine (the dipcall asm20 preset uses -O 5,56 -E 4,1,
    volcanosv-vc-small-indel.py:85-95)."""
    match: int = 2
    mismatch: int = -4
    gap_open: int = -4
    gap_extend: int = -2
    gap_open2: int | None = None
    gap_extend2: int | None = None

    @property
    def dual(self) -> bool:
        return self.gap_open2 is not None

    @staticmethod
    def edit() -> "Scores":
        """Unit-cost scores: -score == edit distance (match=0)."""
        return Scores(match=0, mismatch=-1, gap_open=0, gap_extend=-1)


def _prefix_max_exclusive(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive running max along the last axis in log2(W) shifts."""
    W = x.shape[-1]
    # shift right by 1 → exclusive
    y = jnp.concatenate([jnp.full(x.shape[:-1] + (1,), NEG, x.dtype), x[..., :-1]], -1)
    shift = 1
    while shift < W:
        y = jnp.maximum(y, jnp.concatenate(
            [jnp.full(x.shape[:-1] + (shift,), NEG, x.dtype), y[..., :-shift]], -1))
        shift *= 2
    return y


@functools.partial(
    jax.jit,
    static_argnames=(
        "W", "d_lo", "scores", "with_traceback", "free_t_end", "free_t_start",
        "row0_scores"),
)
def banded_align_scan(
    q: jnp.ndarray,          # (B, M) int8 codes, padded
    t: jnp.ndarray,          # (B, N) int8 codes, padded
    qlen: jnp.ndarray,       # (B,) int32
    tlen: jnp.ndarray,       # (B,) int32
    W: int = 256,
    d_lo: int = -64,
    scores: Scores = Scores(),
    with_traceback: bool = True,
    free_t_end: bool = False,
    free_t_start: bool = False,
    row0_scores: bool = False,
):
    """Banded global alignment of each (q[b,:qlen], t[b,:tlen]) pair.

    Requires d_lo <= 0 and (tlen-qlen) - d_lo < W for the optimum to stay in
    band (caller marshals windows accordingly).

    Returns (score (B,), tb (M, B, W) uint8 or None, end_j (B,) int32).
    With free_t_end=True the alignment may end at any target column on the
    last query row; with free_t_start=True it may start at any column
    (fitting/'glocal' alignment, used for INS→ref realignment,
    align_ins2ref.py equivalent)."""
    B, M = q.shape
    N = t.shape[1]
    go, ge = jnp.int32(scores.gap_open), jnp.int32(scores.gap_extend)
    dual = scores.dual
    if dual:
        go2 = jnp.int32(scores.gap_open2)
        ge2 = jnp.int32(scores.gap_extend2)
    lanes = jnp.arange(W, dtype=jnp.int32)

    def gap_score(k):
        """Best score of a length-k run gap (k ≥ 1)."""
        s = go + ge * k
        return jnp.maximum(s, go2 + ge2 * k) if dual else s

    # row -1 init: lane l ↔ j = -1 + d_lo + l
    j_init = -1 + d_lo + lanes
    if free_t_start:
        H0 = jnp.where((j_init >= -1) & (j_init < tlen[:, None]),
                       0, NEG).astype(jnp.int32)
    else:
        H0 = jnp.where(
            j_init == -1, 0,
            jnp.where((j_init >= 0) & (j_init < tlen[:, None]),
                      gap_score(j_init + 1), NEG)).astype(jnp.int32)
    E0 = jnp.full((B, W), NEG, jnp.int32)

    # pad t so dynamic slicing never clips: indices i+d_lo ∈ [d_lo, M-1+d_lo]
    pad_l = max(0, -d_lo)
    pad_r = max(0, M + d_lo + W - N)
    t_pad = jnp.pad(t, ((0, 0), (pad_l, pad_r)), constant_values=4)

    ge_l = ge * lanes  # static per-lane drift for the F prefix scan
    if dual:
        ge2_l = ge2 * lanes

    def step(carry, i):
        if dual:
            H_prev, E_prev, E2_prev, best, best_j = carry
        else:
            H_prev, E_prev, best, best_j = carry
        j = i + d_lo + lanes                       # (W,) target cols this row
        j_valid = (j >= 0) & (j[None, :] < tlen[:, None])
        row_valid = i < qlen                        # (B,)
        qi = jax.lax.dynamic_slice(q, (0, i), (B, 1)).astype(jnp.int32)   # (B,1)
        tw = jax.lax.dynamic_slice(
            t_pad, (0, i + d_lo + pad_l), (B, W)).astype(jnp.int32)       # (B,W)
        is_match = (qi == tw) & (qi < 4) & (tw < 4)
        sub = jnp.where(is_match, scores.match, scores.mismatch).astype(jnp.int32)

        # E: vertical (consume query), pred = prev row lane l+1
        H_up = jnp.concatenate([H_prev[:, 1:], jnp.full((B, 1), NEG)], 1)
        E_up = jnp.concatenate([E_prev[:, 1:], jnp.full((B, 1), NEG)], 1)
        E_open = H_up + go + ge
        E_ext = E_up + ge
        E = jnp.maximum(E_open, E_ext)
        e_open_bit = (E_open >= E_ext)

        Hdiag = H_prev + sub
        Htmp = jnp.maximum(Hdiag, E)
        choice = jnp.where(E > Hdiag, jnp.uint8(TB_UP), jnp.uint8(TB_DIAG))
        if dual:
            E2_up = jnp.concatenate([E2_prev[:, 1:], jnp.full((B, 1), NEG)], 1)
            E2_open = H_up + go2 + ge2
            E2_ext = E2_up + ge2
            E2 = jnp.maximum(E2_open, E2_ext)
            e2_open_bit = (E2_open >= E2_ext)
            choice = jnp.where(E2 > Htmp, jnp.uint8(TB_UP2), choice)
            Htmp = jnp.maximum(Htmp, E2)

        # inject column -1 boundary H(i,-1) at lane -1-i-d_lo
        lb = -1 - i - d_lo
        boundary = gap_score(i + 1)
        inject = (lanes == lb)
        Htmp = jnp.where(inject[None, :], boundary, Htmp)

        # F: horizontal within the row (exact affine via prefix max)
        # F[l] = max_{s<l} Htmp[s] + go + ge*(l-s)
        pm = _prefix_max_exclusive(Htmp - ge_l[None, :])
        F = pm + ge_l[None, :] + go
        # F-open bit: F[l] achieved by opening at l-1 (vs extending a run)
        H_left = jnp.concatenate([jnp.full((B, 1), NEG), Htmp[:, :-1]], 1)
        f_open_bit = (H_left + go + ge) >= F

        H = jnp.maximum(Htmp, F)
        choice = jnp.where(F > Htmp, jnp.uint8(TB_LEFT), choice)
        if dual:
            pm2 = _prefix_max_exclusive(Htmp - ge2_l[None, :])
            F2 = pm2 + ge2_l[None, :] + go2
            f2_open_bit = (H_left + go2 + ge2) >= F2
            choice = jnp.where(F2 > H, jnp.uint8(TB_LEFT2), choice)
            H = jnp.maximum(H, F2)

        cell_valid = j_valid & row_valid[:, None]
        H = jnp.where(cell_valid | inject[None, :], H, NEG)
        E = jnp.where(cell_valid, E, NEG)
        if dual:
            E2 = jnp.where(cell_valid, E2, NEG)

        # capture global score at (qlen-1, tlen-1) — lane tlen-qlen-d_lo
        if free_t_end:
            last_row = (i == qlen - 1)
            row_best_val = jnp.max(jnp.where(j_valid, H, NEG), axis=1)
            row_best_lane = jnp.argmax(jnp.where(j_valid, H, NEG), axis=1)
            new_best = jnp.where(last_row, row_best_val, best)
            new_best_j = jnp.where(
                last_row, (i + d_lo + row_best_lane).astype(jnp.int32), best_j)
        else:
            l_star = (tlen - qlen - d_lo).astype(jnp.int32)
            val = jnp.take_along_axis(
                H, jnp.clip(l_star, 0, W - 1)[:, None], axis=1)[:, 0]
            last_row = (i == qlen - 1)
            new_best = jnp.where(last_row, val, best)
            new_best_j = jnp.where(last_row, tlen - 1, best_j)

        tb_row = choice
        tb_row = tb_row | jnp.where(e_open_bit, jnp.uint8(TB_E_OPEN), jnp.uint8(0))
        tb_row = tb_row | jnp.where(f_open_bit, jnp.uint8(TB_F_OPEN), jnp.uint8(0))
        if dual:
            tb_row = tb_row | jnp.where(e2_open_bit, jnp.uint8(TB_E2_OPEN),
                                        jnp.uint8(0))
            tb_row = tb_row | jnp.where(f2_open_bit, jnp.uint8(TB_F2_OPEN),
                                        jnp.uint8(0))

        outs = []
        if with_traceback:
            outs.append(tb_row)
        if row0_scores:
            # H on diagonal 0 (lane -d_lo): score of q[0..i] vs t[0..i]
            outs.append(H[:, -d_lo])
        new_carry = (H, E, E2, new_best, new_best_j) if dual \
            else (H, E, new_best, new_best_j)
        return new_carry, tuple(outs)

    zb = jnp.full((B,), NEG, jnp.int32)
    zj = jnp.zeros((B,), jnp.int32)
    init = (H0, E0, jnp.full((B, W), NEG, jnp.int32), zb, zj) if dual \
        else (H0, E0, zb, zj)
    carry_f, outs = jax.lax.scan(
        step, init, jnp.arange(M, dtype=jnp.int32))
    best, best_j = carry_f[-2], carry_f[-1]
    tb = outs[0] if with_traceback else None
    row0 = outs[-1] if row0_scores else None
    if row0_scores:
        return best, tb, best_j, row0
    return best, tb, best_j


@dataclass(frozen=True)
class DPKernel:
    """One platform's banded DP.  `align` takes banded_align_scan's
    arguments and returns (score (B,), tb (M, B, W) uint8 | None,
    end_j (B,), row0 (M, B) | None); `walk(tb, qlen, tlen, d_lo, n_steps)`
    turns a traceback into the packed op stream of _walk_device(pack=True).
    Both trace inside jit and shard_map."""
    name: str
    align: Callable
    walk: Callable


def _scan_align(q, t, qlen, tlen, *, W, d_lo, scores, with_traceback=True,
                free_t_end=False, row0_scores=False):
    out = banded_align_scan(q, t, qlen, tlen, W=W, d_lo=d_lo, scores=scores,
                            with_traceback=with_traceback,
                            free_t_end=free_t_end, row0_scores=row0_scores)
    return out if row0_scores else (*out, None)


def _scan_walk(tb, qlen, tlen, d_lo, n_steps):
    return _walk_device(tb, qlen, tlen, d_lo, n_steps, pack=True)[0]


SCAN = DPKernel("scan", _scan_align, _scan_walk)


def dp_kernel(platform: str | None = None) -> DPKernel:
    """The banded-DP implementation for `platform` (default: the platform
    of the first JAX device): the Hopper kernel (ops/gpu) on "gpu", XLA's
    lax.scan on "cpu".  Any other platform is an error."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "cpu":
        return SCAN
    if platform == "gpu":
        return _cuda_kernel()
    raise RuntimeError(f"no banded-DP kernel for platform {platform!r}")


@functools.cache
def _cuda_kernel() -> DPKernel:
    from . import gpu
    gpu.register()
    return DPKernel("cuda", gpu.banded_dp, gpu.walk)


@functools.partial(jax.jit, static_argnames=("d_lo", "n_steps", "pack"))
def _walk_device(tb, qlen, tlen, d_lo: int, n_steps: int, pack: bool = False):
    """Batched traceback walk on the device over a (M, B, W) traceback,
    as a lax.scan.  Emits (n_steps, B) uint8 op codes in reverse walk
    order (0=M, 1=I, 2=D, 3=none), so only (steps x B) bytes cross to the
    host instead of the (M x B x W) tensor.  Exactly mirrors
    traceback_cigar.

    With pack=True (requires n_steps % 4 == 0) four consecutive 2-bit ops
    are packed per byte on device → (n_steps//4, B) uint8, a further 4×
    cut on the host fetch; _unpack_ops restores the stream.

    Also returns the final per-row `done` flags: entering a gap run costs
    one extra no-move step, so a caller-chosen n_steps can under-shoot on
    gap-dense alignments (see _walk_steps)."""
    if pack:
        assert n_steps % 4 == 0, f"pack=True needs n_steps % 4 == 0, got {n_steps}"
    M, B, W = tb.shape
    flat = tb.reshape(-1)
    cols = jnp.arange(B, dtype=jnp.int32)
    i = qlen.astype(jnp.int32) - 1
    j = tlen.astype(jnp.int32) - 1
    state = jnp.zeros(B, jnp.int32)
    done = (i < 0) & (j < 0)

    def step(carry, _):
        i, j, state, done = carry
        l = j - i - d_lo
        in_band = (l >= 0) & (l < W) & (i >= 0) & (j >= 0)
        idx = (jnp.clip(i, 0, M - 1) * B + cols) * W + jnp.clip(l, 0, W - 1)
        cell = jnp.take(flat, idx).astype(jnp.int32)
        cell = jnp.where(in_band, cell, TB_DIAG)
        i_neg, j_neg = i < 0, j < 0
        choice = cell & TB_CHOICE
        s0 = state == 0
        s0_diag = s0 & (choice == TB_DIAG)
        # states: 1=E(up/I), 2=F(left/D), 3=E2, 4=F2
        s_up = (state == 1) | (state == 3)
        s_left = (state == 2) | (state == 4)
        op = jnp.where(done, 3,
             jnp.where(i_neg, 2,
             jnp.where(j_neg, 1,
             jnp.where(s0_diag, 0,
             jnp.where(s_up, 1,
             jnp.where(s_left, 2, 3))))))
        di = jnp.where(done | i_neg, 0,
             jnp.where(j_neg, 1,
             jnp.where(s0_diag | s_up, 1, 0)))
        dj = jnp.where(done, 0,
             jnp.where(i_neg, 1,
             jnp.where(j_neg, 0,
             jnp.where(s0_diag | s_left, 1, 0))))
        gap_closed = ((state == 1) & ((cell & TB_E_OPEN) != 0)) | \
                     ((state == 2) & ((cell & TB_F_OPEN) != 0)) | \
                     ((state == 3) & ((cell & TB_E2_OPEN) != 0)) | \
                     ((state == 4) & ((cell & TB_F2_OPEN) != 0))
        new_state = jnp.where(done | i_neg | j_neg, state,
                    jnp.where(s0 & (choice == TB_UP), 1,
                    jnp.where(s0 & (choice == TB_UP2), 3,
                    jnp.where(s0 & (choice == TB_LEFT), 2,
                    jnp.where(s0 & (choice == TB_LEFT2), 4,
                    jnp.where(gap_closed, 0, state))))))
        i2, j2 = i - di, j - dj
        done2 = done | ((i2 < 0) & (j2 < 0))
        return (i2, j2, new_state, done2), op.astype(jnp.uint8)

    carry, ops = jax.lax.scan(step, (i, j, state, done), None,
                              length=n_steps)
    if pack:
        o = ops.reshape(n_steps // 4, 4, B).astype(jnp.uint8)
        ops = (o[:, 0] | (o[:, 1] << 2) | (o[:, 2] << 4) | (o[:, 3] << 6))
    return ops, carry[3]


def _unpack_ops(packed: np.ndarray) -> np.ndarray:
    """(n_steps//4, B) packed bytes → (n_steps, B) op codes 0..3."""
    shifts = np.array([0, 2, 4, 6], np.uint8)
    return ((packed[:, None, :] >> shifts[None, :, None]) & 3).reshape(
        -1, packed.shape[1])


def _rle_column(col: np.ndarray) -> list[tuple[int, int]]:
    """Reverse-order op stream → forward CIGAR [(op, len)]."""
    col = col[::-1]
    col = col[col != 3]
    if len(col) == 0:
        return []
    brk = np.nonzero(np.diff(col))[0] + 1
    starts = np.concatenate([[0], brk])
    stops = np.concatenate([brk, [len(col)]])
    return [(int(col[s]), int(e - s)) for s, e in zip(starts, stops)]


def _rle_columns(ops: np.ndarray, n_cols: int) -> list[list[tuple[int, int]]]:
    """Vectorized _rle_column over the first n_cols columns of a reverse-
    order (steps, B) op stream: one numpy pass over the whole batch instead
    of a python loop per alignment (the CIGAR-decode stage was the hottest
    host step at B≈4k windows)."""
    steps = ops.shape[0]
    fwd = ops[::-1, :n_cols].T                      # (n_cols, steps) forward
    flat = fwd.reshape(-1)
    keep = flat != 3
    f = flat[keep]
    if len(f) == 0:
        return [[] for _ in range(n_cols)]
    col = np.repeat(np.arange(n_cols, dtype=np.int64), steps)[keep]
    brk = np.nonzero((f[1:] != f[:-1]) | (col[1:] != col[:-1]))[0] + 1
    starts = np.concatenate([[0], brk])
    stops = np.concatenate([brk, [len(f)]])
    run_op = f[starts].tolist()
    run_len = (stops - starts).tolist()
    run_col = col[starts].tolist()
    out: list[list[tuple[int, int]]] = [[] for _ in range(n_cols)]
    for o, ln, c in zip(run_op, run_len, run_col):
        out[c].append((int(o), int(ln)))
    return out


def _walk_steps(M: int, W: int, qlen, tlen) -> tuple[int, int]:
    """(bucketed, full) step bounds of the traceback walk.  A walk takes
    qlen+tlen steps plus one no-move step per gap run.  The bucket rounds
    max(qlen+tlen)+8 up to a multiple of 256 (a bounded set of compiled
    shapes, and a multiple of 4 for the 2-bit packing); the full bound
    qlen+tlen+min(qlen,tlen)+1 ≤ 3M+W+1 covers every alignment."""
    full = -(-(3 * M + W + 4) // 4) * 4
    need = int(np.max(np.asarray(qlen) + np.asarray(tlen))) + 8
    return min(full, -(-need // 256) * 256), full


@functools.partial(jax.jit,
                   static_argnames=("kern", "W", "d_lo", "scores", "n_steps"))
def _align_walk(q, t, qlen, tlen, *, kern: DPKernel, W: int, d_lo: int,
                scores: Scores, n_steps: int):
    """DP and traceback walk in one program: the (M, B, W) traceback never
    leaves the device; the result is the packed op stream."""
    _s, tb, _e, _r = kern.align(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                scores=scores)
    return kern.walk(tb, qlen, tlen, d_lo, n_steps)


@functools.cache
def _sharded_align_walk(mesh, kern: DPKernel, W: int, d_lo: int,
                        scores: Scores, n_steps: int):
    """_align_walk shard_map'ed over the mesh's batch axes: each device
    runs the DP and the walk on its 1/N slice of the window batch."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import AXES
    spec = P((AXES.genome, AXES.data))
    body = functools.partial(_align_walk, kern=kern, W=W, d_lo=d_lo,
                             scores=scores, n_steps=n_steps)
    return jax.jit(shard_map(
        body, mesh=mesh, in_specs=(spec, spec, spec, spec),
        out_specs=P(None, (AXES.genome, AXES.data)), check_vma=False))


def banded_align_cigars_dispatch(q, t, qlen, tlen, W: int = 256,
                                 d_lo: int = -64, scores: Scores = Scores()):
    """Async half of banded_align_cigars: launches the DP and the
    traceback walk on the device WITHOUT fetching, and returns a finish()
    closure producing the CIGAR list.  Callers dispatch every bucket group
    first, then finish in order — the device works through later groups
    while the host run-length-decodes earlier ones.

    With an active pipeline mesh (parallel.mesh.set_active_mesh) whose
    size divides the batch, the batch is shard_map'ed over the mesh's
    batch axes instead."""
    from ..parallel.mesh import active_mesh, batch_sharding
    kern = dp_kernel()
    B, M = q.shape
    mesh = active_mesh()
    if mesh is not None and (mesh.devices.size == 1
                             or B % mesh.devices.size):
        mesh = None
    n_steps, full = _walk_steps(M, W, qlen, tlen)
    ql_np = np.asarray(qlen, np.int32)
    tl_np = np.asarray(tlen, np.int32)

    def launch(steps: int):
        if mesh is None:
            return _align_walk(q, t, ql_np, tl_np, kern=kern, W=W, d_lo=d_lo,
                               scores=scores, n_steps=steps)
        sh = batch_sharding(mesh)
        args = [jax.device_put(np.asarray(a), sh)
                for a in (q, t, ql_np, tl_np)]
        return _sharded_align_walk(mesh, kern, W, d_lo, scores, steps)(*args)

    packed = launch(n_steps)

    def complete(ops) -> bool:
        """Each row's op stream consumes exactly qlen query and tlen
        target bases — catches walks cut short by the bucketed bound."""
        cq = np.count_nonzero((ops == 0) | (ops == 1), axis=0)
        ct = np.count_nonzero((ops == 0) | (ops == 2), axis=0)
        return bool(np.all(cq == ql_np) and np.all(ct == tl_np))

    def finish():
        ops = _unpack_ops(np.asarray(packed))           # one fetch
        if not complete(ops) and n_steps < full:
            # rare gap-dense batch: rerun with the full step bound
            ops = _unpack_ops(np.asarray(launch(full)))
        if not complete(ops):
            raise AssertionError(
                "traceback walk unfinished at the full step bound")
        return _rle_columns(ops, B)

    return finish


def banded_align_cigars(q, t, qlen, tlen, W: int = 256, d_lo: int = -64,
                        scores: Scores = Scores()) -> list:
    """Batched global banded alignment → exact CIGARs, one per row.  The
    traceback is walked on the device; only the op stream is fetched."""
    return banded_align_cigars_dispatch(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                        scores=scores)()


def banded_row0_auto(q, t, qlen, tlen, W: int = 128, d_lo: int = -64,
                     scores: Scores = Scores()) -> np.ndarray:
    """Diagonal-0 score profile (M, B) for the split-DP breakpoint search,
    on the platform's kernel (dp_kernel)."""
    _, _, _, row0 = dp_kernel().align(
        q, t, qlen, tlen, W=W, d_lo=d_lo, scores=scores,
        with_traceback=False, row0_scores=True)
    return np.asarray(row0)


def edit_distance_batch_auto(q, t, qlen, tlen, W: int = 128,
                             d_lo: int | None = None):
    """Batched banded edit distance on the platform's kernel (replaces
    edlib): distance = -score with unit costs.  Returns (B,) int32
    distances (band-limited lower bound)."""
    if d_lo is None:
        d_lo = -(W // 2)
    score, _, _, _ = dp_kernel().align(
        q, t, qlen, tlen, W=W, d_lo=d_lo, scores=Scores.edit(),
        with_traceback=False)
    return -np.asarray(score)


def traceback_cigar(tb: np.ndarray, qlen: int, tlen: int, d_lo: int,
                    end_j: int | None = None,
                    free_t_start: bool = False) -> list[tuple[int, int]]:
    """Walk the traceback for one alignment → CIGAR [(op, len)] with op in
    {0:M, 1:I, 2:D} (query-consuming I, target-consuming D). Host-side.
    With free_t_start the walk stops once the query is consumed (the leading
    target skip is not part of the alignment)."""
    ops: list[tuple[int, int]] = []
    i = qlen - 1
    j = (tlen - 1) if end_j is None else int(end_j)
    W = tb.shape[-1]

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))

    state = 0  # 0=H, 1=E(up/I), 2=F(left/D), 3=E2, 4=F2
    open_bit = {1: TB_E_OPEN, 2: TB_F_OPEN, 3: TB_E2_OPEN, 4: TB_F2_OPEN}
    # each gap run costs one no-move state-entry iteration on top of the
    # qlen+tlen moves, so bound by qlen+tlen+min(qlen,tlen) (+band slack)
    guard = qlen + tlen + min(qlen, tlen) + 2 * W + 10
    while (i >= 0 or j >= 0) and guard > 0:
        guard -= 1
        if i < 0:
            if free_t_start:
                break
            push(2); j -= 1; continue
        if j < 0:
            push(1); i -= 1; continue
        l = j - i - d_lo
        cell = int(tb[i, l]) if 0 <= l < W else TB_DIAG
        if state == 0:
            choice = cell & TB_CHOICE
            if choice == TB_DIAG:
                push(0); i -= 1; j -= 1
            elif choice == TB_UP:
                state = 1
            elif choice == TB_UP2:
                state = 3
            elif choice == TB_LEFT:
                state = 2
            else:
                state = 4
        elif state in (1, 3):
            push(1)
            opened = bool(cell & open_bit[state])
            i -= 1
            if opened:
                state = 0
        else:
            push(2)
            opened = bool(cell & open_bit[state])
            j -= 1
            if opened:
                state = 0
    ops.reverse()
    return ops


# ---------------------------------------------------------------------------
# host-side exact full DP (tiny inputs, unit tests only)
# ---------------------------------------------------------------------------

def full_affine_score_np(q: np.ndarray, t: np.ndarray, s: Scores = Scores()) -> int:
    """O(mn) full-matrix (dual-)affine global alignment score (test oracle)."""
    m, n = len(q), len(t)
    NEGI = -(10**9) // 2
    H = np.full(n + 1, NEGI, np.int64)
    E = np.full(n + 1, NEGI, np.int64)
    E2 = np.full(n + 1, NEGI, np.int64)
    go2 = s.gap_open2 if s.dual else None
    ge2 = s.gap_extend2 if s.dual else None

    def gap(k):
        v = s.gap_open + s.gap_extend * k
        return max(v, go2 + ge2 * k) if s.dual else v

    H[0] = 0
    for j in range(1, n + 1):
        H[j] = gap(j)
    for i in range(1, m + 1):
        diag = H.copy()
        H[0] = gap(i)
        F = NEGI
        F2 = NEGI
        for j in range(1, n + 1):
            E[j] = max(diag[j] + s.gap_open + s.gap_extend, E[j] + s.gap_extend)
            F = max(H[j - 1] + s.gap_open + s.gap_extend, F + s.gap_extend)
            sub = s.match if (q[i - 1] == t[j - 1] and q[i - 1] < 4) else s.mismatch
            best = max(diag[j - 1] + sub, E[j], F)
            if s.dual:
                E2[j] = max(diag[j] + go2 + ge2, E2[j] + ge2)
                F2 = max(H[j - 1] + go2 + ge2, F2 + ge2)
                best = max(best, E2[j], F2)
            H[j] = best
    return int(H[n])


def pad_batch_pow2(q, t, qlen, tlen, min_b: int = 64):
    """Pad the batch dim to a power of two so each (B, M, N, W) shape family
    compiles once.  Padding rows get qlen=tlen=1 (trivially in-band).
    Returns (q, t, qlen, tlen, original_B).

    min_b=64 folds small batches (8/16/32 rows) into one compiled shape;
    the padded rows are in-band one-base alignments.  Whether the floor
    pays on the GPU is not measured."""
    B = q.shape[0]
    Bp = max(min_b, 1 << max(0, (B - 1).bit_length()))
    if Bp == B:
        return q, t, qlen, tlen, B
    pb = Bp - B
    q = np.concatenate([q, np.full((pb, q.shape[1]), 4, q.dtype)])
    t = np.concatenate([t, np.full((pb, t.shape[1]), 4, t.dtype)])
    qlen = np.concatenate([qlen, np.ones(pb, qlen.dtype)])
    tlen = np.concatenate([tlen, np.ones(pb, tlen.dtype)])
    return q, t, qlen, tlen, B
