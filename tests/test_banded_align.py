"""Banded DP vs full-matrix oracle + CIGAR traceback validity."""
import numpy as np
import pytest

from volcanosv_tpu.ops.banded_align import (
    Scores, banded_align_scan, edit_distance_batch_auto, full_affine_score_np,
    traceback_cigar,
)
from volcanosv_tpu.ops.pack import encode_seq, pad_codes


def _mutate(rng, seq, n_sub=3, n_ind=2, max_indel=4):
    s = list(seq)
    for _ in range(n_sub):
        i = rng.integers(0, len(s))
        s[i] = rng.choice(list("ACGT"))
    for _ in range(n_ind):
        i = rng.integers(1, len(s) - max_indel - 1)
        if rng.random() < 0.5:
            del s[i : i + int(rng.integers(1, max_indel + 1))]
        else:
            s[i:i] = list(rng.choice(list("ACGT"), int(rng.integers(1, max_indel + 1))))
    return "".join(s)


def _apply_cigar(cigar, q, t):
    """Check that cigar consumes exactly len(q) query and len(t) target."""
    qi = ti = 0
    for op, ln in cigar:
        if op == 0:
            qi += ln; ti += ln
        elif op == 1:
            qi += ln
        else:
            ti += ln
    return qi, ti


def test_score_matches_full_dp(rng):
    qs, ts = [], []
    for _ in range(8):
        t = "".join(rng.choice(list("ACGT"), 120))
        q = _mutate(rng, t)
        qs.append(encode_seq(q)); ts.append(encode_seq(t))
    q_pad, qlen = pad_codes(qs, pad_to=160)
    t_pad, tlen = pad_codes(ts, pad_to=160)
    score, tb, end_j = banded_align_scan(
        q_pad, t_pad, qlen, tlen, W=128, d_lo=-64)
    score = np.asarray(score)
    for b in range(8):
        oracle = full_affine_score_np(qs[b], ts[b])
        assert score[b] == oracle, (b, score[b], oracle)


def test_traceback_cigar_consumes_both(rng):
    qs, ts = [], []
    for _ in range(4):
        t = "".join(rng.choice(list("ACGT"), 100))
        q = _mutate(rng, t)
        qs.append(encode_seq(q)); ts.append(encode_seq(t))
    q_pad, qlen = pad_codes(qs, pad_to=128)
    t_pad, tlen = pad_codes(ts, pad_to=128)
    score, tb, _ = banded_align_scan(q_pad, t_pad, qlen, tlen, W=128, d_lo=-64)
    tb = np.asarray(tb)  # (M, B, W)
    for b in range(4):
        cig = traceback_cigar(tb[:, b], int(qlen[b]), int(tlen[b]), d_lo=-64)
        qi, ti = _apply_cigar(cig, qs[b], ts[b])
        assert qi == qlen[b] and ti == tlen[b]


def test_traceback_score_consistency(rng):
    """Score recomputed from the CIGAR path equals the DP score."""
    s = Scores()
    t = "".join(rng.choice(list("ACGT"), 150))
    q = _mutate(rng, t, n_sub=5, n_ind=3)
    qc, tc = encode_seq(q), encode_seq(t)
    q_pad, qlen = pad_codes([qc], pad_to=256)
    t_pad, tlen = pad_codes([tc], pad_to=256)
    score, tb, _ = banded_align_scan(q_pad, t_pad, qlen, tlen, W=128, d_lo=-64)
    cig = traceback_cigar(np.asarray(tb)[:, 0], len(qc), len(tc), d_lo=-64)
    qi = ti = 0
    total = 0
    for op, ln in cig:
        if op == 0:
            for x in range(ln):
                total += s.match if qc[qi + x] == tc[ti + x] else s.mismatch
            qi += ln; ti += ln
        else:
            total += s.gap_open + s.gap_extend * ln
            if op == 1:
                qi += ln
            else:
                ti += ln
    assert total == int(score[0])


def test_known_deletion_recovered(rng):
    """A 30bp deletion in the query shows up as a 30D run in the CIGAR."""
    t = "".join(rng.choice(list("ACGT"), 300))
    q = t[:150] + t[180:]  # 30bp deletion at position 150
    qc, tc = encode_seq(q), encode_seq(t)
    q_pad, qlen = pad_codes([qc], pad_to=384)
    t_pad, tlen = pad_codes([tc], pad_to=384)
    score, tb, _ = banded_align_scan(q_pad, t_pad, qlen, tlen, W=128, d_lo=-32)
    cig = traceback_cigar(np.asarray(tb)[:, 0], len(qc), len(tc), d_lo=-32)
    dels = [(op, ln) for op, ln in cig if op == 2]
    assert dels == [(2, 30)]
    # and it sits at target offset 150 +- a few bp (homopolymer slack)
    ti = 0
    for op, ln in cig:
        if op == 2:
            break
        if op in (0,):
            ti += ln
    assert abs(ti - 150) <= 5


def test_known_insertion_recovered(rng):
    t = "".join(rng.choice(list("ACGT"), 300))
    ins = "".join(rng.choice(list("ACGT"), 42))
    q = t[:100] + ins + t[100:]
    qc, tc = encode_seq(q), encode_seq(t)
    q_pad, qlen = pad_codes([qc], pad_to=384)
    t_pad, tlen = pad_codes([tc], pad_to=384)
    score, tb, _ = banded_align_scan(q_pad, t_pad, qlen, tlen, W=128, d_lo=-96)
    cig = traceback_cigar(np.asarray(tb)[:, 0], len(qc), len(tc), d_lo=-96)
    inss = [(op, ln) for op, ln in cig if op == 1]
    assert (1, 42) in inss


def test_edit_distance_matches_naive(rng):
    def lev(a, b):
        dp = np.arange(len(b) + 1)
        for i in range(1, len(a) + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, len(b) + 1):
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                            prev[j - 1] + (a[i - 1] != b[j - 1]))
        return dp[-1]

    qs, ts = [], []
    strs = []
    for _ in range(6):
        t = "".join(rng.choice(list("ACGT"), 80))
        q = _mutate(rng, t, n_sub=4, n_ind=2)
        strs.append((q, t))
        qs.append(encode_seq(q)); ts.append(encode_seq(t))
    q_pad, qlen = pad_codes(qs, pad_to=128)
    t_pad, tlen = pad_codes(ts, pad_to=128)
    d = np.asarray(edit_distance_batch_auto(q_pad, t_pad, qlen, tlen, W=128))
    for b, (q, t) in enumerate(strs):
        assert d[b] == lev(q, t)


def test_free_t_end_semiglobal(rng):
    """Query aligned into a longer target window ends at the right column."""
    t = "".join(rng.choice(list("ACGT"), 400))
    q = t[37:137]  # exact slice
    qc, tc = encode_seq(q), encode_seq(t)
    q_pad, qlen = pad_codes([qc], pad_to=128)
    t_pad, tlen = pad_codes([tc], pad_to=512)
    score, tb, end_j = banded_align_scan(
        q_pad, t_pad, qlen, tlen, W=256, d_lo=0,
        free_t_end=True, free_t_start=True)
    assert int(score[0]) == 100 * 2  # all matches
    assert int(end_j[0]) == 136


DUAL = Scores(match=2, mismatch=-4, gap_open=-4, gap_extend=-2,
              gap_open2=-24, gap_extend2=-1)


def test_dual_affine_matches_full_dp(rng):
    """Dual-affine (minimap2 -O o1,o2 -E e1,e2; dipcall asm20 preset,
    volcanosv-vc-small-indel.py:85-95) vs the O(mn) oracle — long gaps must
    take the cheaper second class."""
    qs, ts = [], []
    for _ in range(8):
        t = "".join(rng.choice(list("ACGT"), 120))
        q = _mutate(rng, t, n_ind=2, max_indel=30)   # long indels
        qs.append(encode_seq(q)); ts.append(encode_seq(t))
    q_pad, qlen = pad_codes(qs, pad_to=160)
    t_pad, tlen = pad_codes(ts, pad_to=160)
    score, tb, _ = banded_align_scan(
        q_pad, t_pad, qlen, tlen, W=128, d_lo=-64, scores=DUAL)
    score = np.asarray(score)
    tb = np.asarray(tb)
    for b in range(8):
        oracle = full_affine_score_np(qs[b], ts[b], DUAL)
        assert score[b] == oracle, (b, score[b], oracle)
        # single-affine scores the same gaps lower
        single = full_affine_score_np(qs[b], ts[b])
        assert oracle >= single
        cig = traceback_cigar(tb[:, b], int(qlen[b]), int(tlen[b]), d_lo=-64)
        qi, ti = _apply_cigar(cig, qs[b], ts[b])
        assert (qi, ti) == (len(qs[b]), len(ts[b]))


def test_dual_affine_traceback_score_consistency(rng):
    """Re-scoring the dual-affine CIGAR (each gap at the better of the two
    classes) must reproduce the DP score exactly."""
    t = "".join(rng.choice(list("ACGT"), 200))
    q = _mutate(rng, t, n_sub=4, n_ind=3, max_indel=40)
    qs, ts = encode_seq(q), encode_seq(t)
    q_pad, qlen = pad_codes([qs], pad_to=256)
    t_pad, tlen = pad_codes([ts], pad_to=256)
    score, tb, _ = banded_align_scan(
        q_pad, t_pad, qlen, tlen, W=256, d_lo=-128, scores=DUAL)
    cig = traceback_cigar(np.asarray(tb)[:, 0], len(qs), len(ts), d_lo=-128)
    s = 0
    qi = ti = 0
    for op, ln in cig:
        if op == 0:
            for k in range(ln):
                s += DUAL.match if qs[qi + k] == ts[ti + k] else DUAL.mismatch
            qi += ln; ti += ln
        else:
            s += max(DUAL.gap_open + DUAL.gap_extend * ln,
                     DUAL.gap_open2 + DUAL.gap_extend2 * ln)
            if op == 1:
                qi += ln
            else:
                ti += ln
    assert s == int(np.asarray(score)[0]), (s, int(np.asarray(score)[0]), cig)
