"""End-to-end sequence aligner: minimizer seeding → chaining → batched
banded-DP refinement → BAM records.

Replaces every minimap2 invocation in the reference (SURVEY.md §2.2):
contig→ref asm5/asm10/asm20 (Raw_variant_call.py:49-52,
volcanosv-vc-small-indel.py:85-95, volcanosv-vc-complex-sv.py:110-122),
reads→ref map-* (align_ins2ref.py:64-71), and read-vs-read ava overlap
(General_Assembly_Workflow.py:144).

Structure — three phases:
  A (host)   sketch + anchors + chains + a *window plan*: the irregular work
  B (device) all DP windows across all queries, bucketed by padded shape and
             executed as big batches of the platform's banded-DP kernel,
             traceback walk included (ops.banded_align.dp_kernel)
  C (host)   run-length decode of the op streams + CIGAR assembly

Large indels between adjacent anchors are refined with the two-pass
split-DP: forward and backward diagonal-0 score profiles around the gap,
breakpoint = argmax fwd[s] + bwd[L-s] — a batched, fixed-shape equivalent
of minimap2's long-gap patching.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .config import AlignConfig
from .ops.banded_align import Scores, banded_row0_auto, pad_batch_pow2
from .ops.chain import Chain, chain_anchors
from .ops.minimizer import MinimizerIndex, sketch_np
from .ops.pack import decode_codes, encode_seq, revcomp_codes
from .io.bam import BamRecord, FREVERSE, FSUPPLEMENTARY
from .utils.logging import get_logger, stage_timer

log = get_logger("aligner")

# cigar op codes (BAM)
M, I, D, S = 0, 1, 2, 4

_REFINE_MAX_DIAG = 100        # |dt-dq| handled by one banded window
_REFINE_W = 256
_REFINE_DLO = -128
_SPLIT_W = 128
_SPLIT_DLO = -64
_MAX_WINDOW = 8192
_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)


@dataclass
class Alignment:
    qname: str
    ref_name: str
    ref_id: int
    pos: int                  # 0-based local target start
    strand: int               # +1 / -1
    mapq: int
    cigar: list[tuple[int, int]]   # BAM op codes incl. soft clips
    score: float
    is_supplementary: bool
    qlen: int
    q_start: int              # oriented query coords (in aligned orientation)
    q_end: int

    def t_end(self) -> int:
        return self.pos + sum(l for op, l in self.cigar if op in (M, D))

    def cigar_string(self) -> str:
        from .io.bam import CIGAR_OPS
        return "".join(f"{l}{CIGAR_OPS[op]}" for op, l in self.cigar)


@dataclass
class _Window:
    """One DP task between two anchors of one chain."""
    chain_idx: int
    slot: int                # position in the chain's cigar assembly
    q_codes: np.ndarray
    t_codes: np.ndarray
    kind: str                # 'refine' | 'split'
    indel_op: int = 0        # for split: I or D
    indel_len: int = 0
    result: list | None = None


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _plan_chain(qc: np.ndarray, tget, chain: Chain, cfg: AlignConfig,
                chain_idx: int, windows: list[_Window]):
    """Build the cigar skeleton for one chain; emit _Windows for gaps.

    qc: query codes in chain orientation. tget(a, b): target codes slice in
    global coords.  Returns skeleton: list of either ('cig', [(op,len)]) or
    ('win', window_index)."""
    k = cfg.k
    aq, at = chain.anchors_q, chain.anchors_t
    # chains arrive (t, q)-sorted from the chain DP — skip the O(n log n)
    # lexsort when aq is already strictly increasing (the common case)
    if len(aq) > 1 and not bool(np.all(aq[1:] > aq[:-1])):
        order = np.lexsort((at, aq))
        aq, at = aq[order], at[order]
    # drop anchors that go backwards in either coordinate (not colinear);
    # chains are almost always already strictly increasing — only run the
    # sequential filter when a violation exists
    dq_all = np.diff(aq)
    dt_all = np.diff(at)
    if len(aq) > 1 and not ((dq_all > 0) & (dt_all > 0)).all():
        keep_q, keep_t = [int(aq[0])], [int(at[0])]
        for x, y in zip(aq[1:], at[1:]):
            dx, dy = int(x) - keep_q[-1], int(y) - keep_t[-1]
            if dx > 0 and dy > 0 or (dx == dy == 0):
                if dx > 0:
                    keep_q.append(int(x)); keep_t.append(int(y))
        aq, at = np.array(keep_q), np.array(keep_t)
        dq_all = np.diff(aq)
        dt_all = np.diff(at)

    # The sparse skeleton below only sends the IRREGULAR gap windows to
    # the device, so DP cells and fetched op-stream bytes scale with
    # #indels, not bp.  A whole-chain "DP everything" path (tile the chain
    # into uniform windows) would fetch ~0.5 byte per aligned base; it has
    # not been measured on the GPU.
    skeleton: list = []

    def emit(op, ln):
        if ln > 0:
            skeleton.append(("cig", (op, ln)))

    # anchor pairs on the same diagonal (dq==dt) are pure M runs: collapse
    # maximal runs in one emit and python-walk only the irregular gaps
    # (indels/noise) — O(#gaps) instead of O(#anchors) per chain
    irregular = np.nonzero(dq_all != dt_all)[0]
    prev = 0
    for g in irregular:
        g = int(g)
        emit(M, int(aq[g] - aq[prev]))          # equal-diagonal run
        qcur, tcur = int(aq[g]), int(at[g])
        qa, ta = int(aq[g + 1]), int(at[g + 1])
        dq, dt = qa - qcur, ta - tcur
        if dq == 0:
            emit(D, dt)
        elif dt == 0:
            emit(I, dq)
        elif abs(dt - dq) <= _REFINE_MAX_DIAG and max(dq, dt) <= _MAX_WINDOW:
            w = _Window(chain_idx, len(skeleton),
                        qc[qcur:qa], tget(tcur, ta), "refine")
            windows.append(w)
            skeleton.append(("win", w))
        else:
            L = min(dq, dt)
            indel_op = D if dt > dq else I
            indel_len = abs(dt - dq)
            if L > _MAX_WINDOW:
                # unrefinable: place the indel right after the left anchor
                emit(indel_op, indel_len)
                emit(M, L)
            else:
                w = _Window(chain_idx, len(skeleton),
                            qc[qcur:qa], tget(tcur, ta), "split",
                            indel_op, indel_len)
                windows.append(w)
                skeleton.append(("win", w))
        prev = g + 1
    emit(M, int(aq[-1] - aq[prev]))             # trailing run
    emit(M, k)  # the final anchor's k-mer
    return skeleton, int(aq[0]), int(at[0])


class _RefinePipeline:
    """Streaming refine-window executor: collects windows by bucket as the
    planner emits them (it quacks like the `windows` list _plan_chain
    appends to) and DISPATCHES a device batch whenever a bucket fills —
    the device crunches DP while the host is still seeding/chaining the
    next queries.  finalize() flushes partial buckets, then fetches and
    decodes all results in dispatch order.

    One compiled shape per M bucket: targets always pad to mb + _REFINE_W
    (refine windows satisfy dt ≤ dq + _REFINE_MAX_DIAG < mb + _REFINE_W),
    keeping the compile count at len(_BUCKETS) instead of its square.
    Buckets floor at 256: merging 128 into 256 trades a few cheap device
    cells for one fewer fetch round-trip per flush."""

    def __init__(self, scores: Scores, flush_at: int = 4096,
                 max_inflight: int = 2):
        self.scores = scores
        self.flush_at = flush_at
        # in-flight dispatch cap: resolving the oldest dispatch before
        # launching a new one bounds live device memory (each dispatch's
        # traceback plus its op stream) at max_inflight buckets, while
        # still overlapping host planning with device DP.  Unbounded
        # accumulation once exhausted device memory in the polish stage.
        self.max_inflight = max_inflight
        self.groups: dict[tuple[int, int], list[_Window]] = {}
        self.pending: list = []
        self.split: list[_Window] = []

    # per-dispatch traceback budget: the DP writes an (M, B, W) uint8
    # traceback that the walk reads, so B is capped per M bucket (8192-row
    # buckets at a flat flush_at=4096 would be an 8.6 GB tensor).  512 MB
    # is safe on an 80 GB card; the best value there is not measured.
    _TB_BYTE_CAP = 512 << 20

    def _bucket_flush_at(self, mb: int) -> int:
        cap = max(64, self._TB_BYTE_CAP // (mb * _REFINE_W))
        return min(self.flush_at, cap)

    def append(self, w: _Window) -> None:
        if w.kind != "refine":
            self.split.append(w)
            return
        mb = max(256, _bucket(max(len(w.q_codes),
                                  len(w.t_codes) - _REFINE_W + 1)))
        key = (mb, mb + _REFINE_W)
        grp = self.groups.setdefault(key, [])
        grp.append(w)
        if len(grp) >= self._bucket_flush_at(mb):
            self._flush(key)

    @staticmethod
    def _resolve(entry) -> None:
        grp, finish = entry
        cigs = finish()
        for i, w in enumerate(grp):
            w.result = cigs[i]

    def _flush(self, key: tuple[int, int]) -> None:
        from .ops.banded_align import banded_align_cigars_dispatch
        from .ops.pack import pad_codes
        grp = self.groups.pop(key, [])
        if not grp:
            return
        mb, nb = key
        q_pad, qlen = pad_codes([w.q_codes for w in grp], pad_to=mb)
        t_pad, tlen = pad_codes([w.t_codes for w in grp], pad_to=nb)
        q_pad, t_pad, qlen, tlen, _B = pad_batch_pow2(q_pad, t_pad,
                                                      qlen, tlen)
        while len(self.pending) >= self.max_inflight:
            self._resolve(self.pending.pop(0))
        self.pending.append((grp, banded_align_cigars_dispatch(
            q_pad, t_pad, qlen, tlen, W=_REFINE_W, d_lo=_REFINE_DLO,
            scores=self.scores)))

    def finalize(self) -> None:
        for key in list(self.groups):
            self._flush(key)
        for entry in self.pending:
            self._resolve(entry)
        self.pending = []


def _run_refine(ws: list[_Window], scores: Scores = Scores()):
    """Batch-execute refine windows (list-input convenience wrapper over
    _RefinePipeline, used by tests and non-streaming callers)."""
    pipe = _RefinePipeline(scores)
    for w in ws:
        pipe.append(w)
    pipe.finalize()


def _run_split(ws: list[_Window]):
    """Two diagonal-0 score profiles per window → breakpoint placement."""
    from .ops.pack import pad_codes
    groups: dict[int, list[_Window]] = {}
    for w in ws:
        L = min(len(w.q_codes), len(w.t_codes))
        groups.setdefault(_bucket(L), []).append(w)
    for Lb, grp in groups.items():
        qs, ts = [], []
        for w in grp:
            L = min(len(w.q_codes), len(w.t_codes))
            qs.append(w.q_codes[:L]); ts.append(w.t_codes[:L])            # fwd
            qs.append(w.q_codes[::-1][:L].copy())
            ts.append(w.t_codes[::-1][:L].copy())                          # bwd
        q_pad, qlen = pad_codes(qs, pad_to=Lb)
        t_pad, tlen = pad_codes(ts, pad_to=Lb)
        q_pad, t_pad, qlen, tlen, _B = pad_batch_pow2(q_pad, t_pad, qlen, tlen)
        row0 = banded_row0_auto(
            q_pad, t_pad, qlen, tlen, W=_SPLIT_W, d_lo=_SPLIT_DLO)  # (M, B)
        for i, w in enumerate(grp):
            L = int(qlen[2 * i])
            fwd = np.concatenate([[0], row0[:L, 2 * i]])      # F[s], s=0..L
            bwd = np.concatenate([[0], row0[:L, 2 * i + 1]])  # B[r], r=0..L
            s = int(np.argmax(fwd + bwd[::-1]))
            cig: list[tuple[int, int]] = []
            if s > 0:
                cig.append((M, s))
            cig.append((w.indel_op, w.indel_len))
            # any residual length difference beyond the main indel is noise;
            # absorb into flanking M (lengths were L=min(dq,dt) on both sides)
            if L - s > 0:
                cig.append((M, L - s))
            w.result = cig


def _ref_to_query(ops: np.ndarray, lens: np.ndarray, r0s: np.ndarray,
                  q0s: np.ndarray, r: int) -> int:
    """Query offset (alignment orientation, clips included) at ref pos r."""
    consumes_ref = np.isin(ops, (M, D))
    idx = np.nonzero(consumes_ref & (r0s <= r)
                     & (r < r0s + lens * consumes_ref))[0]
    if len(idx) == 0:
        # r at/after the last ref-consuming op
        last = np.nonzero(consumes_ref)[0]
        if len(last) == 0:
            return 0
        i = int(last[-1])
        if r >= int(r0s[i] + lens[i]):
            return int(q0s[i]) + (int(lens[i]) if ops[i] == M else 0)
        i = int(last[0])
        return int(q0s[i])
    i = int(idx[0])
    if ops[i] == M:
        return int(q0s[i]) + (r - int(r0s[i]))
    return int(q0s[i])          # inside a D: query does not advance


def _cigar_score(cig: list[tuple[int, int]], q: np.ndarray, t: np.ndarray,
                 s: Scores) -> int:
    """(Dual-)affine score of a given global-alignment cigar."""
    qp = tp = 0
    score = 0
    for op, ln in cig:
        ln = int(ln)
        if op == M:
            a, b = q[qp:qp + ln], t[tp:tp + ln]
            n_match = int(np.count_nonzero((a == b) & (a < 4)))
            score += n_match * s.match + (ln - n_match) * s.mismatch
            qp += ln
            tp += ln
        elif op in (I, D):
            g = s.gap_open + s.gap_extend * ln
            if s.dual:
                g = max(g, s.gap_open2 + s.gap_extend2 * ln)
            score += g
            if op == I:
                qp += ln
            else:
                tp += ln
        elif op == S:
            qp += ln
    return score


def _merge_cigar(parts: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for op, ln in parts:
        if ln <= 0:
            continue
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + ln)
        else:
            out.append((op, ln))
    return out


class Aligner:
    """Reusable aligner over one reference (index built once)."""

    def __init__(self, ref_seqs: dict[str, str], cfg: AlignConfig):
        self.cfg = cfg
        # per-preset DP scores, incl. the dual-affine long-gap class when
        # the preset sets it (asm20/dipcall: minimap2 -O 5,56 -E 4,1,
        # volcanosv-vc-small-indel.py:85-95)
        self.scores = Scores(match=cfg.match, mismatch=cfg.mismatch,
                             gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
                             gap_open2=cfg.gap_open2,
                             gap_extend2=cfg.gap_extend2)
        with stage_timer("index_build", log):
            self.ref_codes = {n: encode_seq(s) for n, s in ref_seqs.items()}
            self.index = MinimizerIndex.build(self.ref_codes, cfg.k, cfg.w)
        self.names = self.index.names
        self.lengths = [len(self.ref_codes[n]) for n in self.names]
        self._ref_concat = None

    def _tget(self, a: int, b: int) -> np.ndarray:
        """Target codes slice in global coords."""
        idx = int(np.searchsorted(self.index.offsets, a, side="right") - 1)
        off = int(self.index.offsets[idx])
        return self.ref_codes[self.names[idx]][a - off : b - off]

    def _seed_chain_stream(self, queries: list[tuple[str, str]],
                           max_chains: int, chunk: int = 512):
        """Yields (qname, qc_fwd, chains) per query.

        Native path: the fused seed_chain_batch kernel runs per chunk on a
        prefetch thread (ctypes releases the GIL), so chunk i+1's
        sketch/lookup/chain overlaps the python planning of chunk i.
        Fallback: the per-query numpy path (identical outputs)."""
        from .native import get_lib
        from .ops.chain import seed_chain_batch
        cfg = self.cfg
        lib = get_lib()
        if lib is None or not hasattr(lib, "seed_chain_batch"):
            for qname, qseq in queries:
                qc_fwd = encode_seq(qseq)
                qp, qh, qs = sketch_np(qc_fwd, cfg.k, cfg.w)
                chains = []
                if len(qp):
                    t_pos, q_pos, strand = self.index.anchors(qp, qh, qs)
                    chains = chain_anchors(t_pos, q_pos, strand, len(qc_fwd),
                                           cfg, max_chains=max_chains)
                yield qname, qc_fwd, self._select(chains, len(qc_fwd))
            return
        from concurrent.futures import ThreadPoolExecutor

        def job(part):
            # primary/supplementary selection runs inside the native call
            # (select_chains in seedchain.cpp — same cover logic as the
            # python _select/_anchor_cover pair)
            qcs = [encode_seq(s) for _, s in part]
            return qcs, seed_chain_batch(qcs, self.index, cfg, max_chains,
                                         select=(self._SEL_HOLE,
                                                 self._SEL_FRAC))

        parts = [queries[i:i + chunk] for i in range(0, len(queries), chunk)]
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(job, parts[0]) if parts else None
            for i, part in enumerate(parts):
                qcs, batched = fut.result()
                fut = ex.submit(job, parts[i + 1]) \
                    if i + 1 < len(parts) else None
                for (qname, _qseq), qc_fwd, chains in zip(part, qcs, batched):
                    yield qname, qc_fwd, chains

    def align(self, queries: list[tuple[str, str]],
              max_chains_per_query: int = 16) -> list[Alignment]:
        """Align queries (name, seq); returns primary + supplementary
        alignments with exact CIGARs."""
        cfg = self.cfg
        plans = []   # (qname, qlen, chain, skeleton, first_aq, first_at, qc)
        # refine windows stream straight into the device pipeline (full
        # buckets dispatch while later queries are still seeding/chaining)
        pipe = _RefinePipeline(self.scores)
        with stage_timer("seed_chain", log):
            for qname, qc_fwd, chains in self._seed_chain_stream(
                    queries, max_chains_per_query):
                qlen = len(qc_fwd)
                if not chains:
                    continue
                qc_rev = None
                for rank, ch in enumerate(chains):
                    # drop chains crossing reference boundaries
                    i0 = np.searchsorted(self.index.offsets, ch.t_start, "right") - 1
                    i1 = np.searchsorted(self.index.offsets, ch.t_end - 1, "right") - 1
                    if i0 != i1:
                        continue
                    if ch.strand == -1:
                        if qc_rev is None:
                            qc_rev = revcomp_codes(qc_fwd)
                        qc = qc_rev
                    else:
                        qc = qc_fwd
                    skeleton, aq0, at0 = _plan_chain(
                        qc, self._tget, ch, cfg, len(plans), pipe)
                    plans.append((qname, qlen, ch, skeleton, aq0, at0, rank))
        with stage_timer("dp_windows", log):
            pipe.finalize()
            _run_split(pipe.split)
        with stage_timer("assemble", log):
            alns = self._assemble(plans)
        if cfg.inv_rescue:
            with stage_timer("inv_rescue", log):
                alns += self._inv_rescue(alns, dict(queries))
        return alns

    def _anchor_cover(self, ch: Chain, qlen: int,
                      hole: int = 100) -> list[tuple[int, int]]:
        """Forward-orientation query intervals actually covered by anchors
        (gaps > `hole` between anchors stay uncovered, so an opposite-strand
        chain filling e.g. an inversion interior is not shadowed)."""
        k = self.cfg.k
        a = ch.anchors_q
        if len(a) > 1 and not bool(np.all(a[1:] >= a[:-1])):
            a = np.sort(a)
        ends = a + k                      # sorted ⇒ ends sorted too
        brk = np.nonzero(a[1:] > ends[:-1] + hole)[0] + 1
        starts = np.concatenate([[0], brk])
        stops = np.concatenate([brk, [len(a)]])
        iv = [(int(a[s]), int(ends[e - 1])) for s, e in zip(starts, stops)]
        if ch.strand == -1:
            iv = [(qlen - e, qlen - s) for s, e in iv]
        return iv

    _SEL_HOLE = 100
    _SEL_FRAC = 0.5

    def _select(self, chains: list[Chain], qlen: int) -> list[Chain]:
        """Primary + non-redundant supplementary selection by query overlap
        against anchor-covered intervals (not whole chain spans).  The
        native path applies the same logic in seedchain.cpp select_chains;
        this python version serves the fallback path (and is the oracle
        the native selection is pinned against in tests)."""
        out: list[Chain] = []
        cov: list[tuple[int, int]] = []
        for ch in chains:
            ov = 0
            for s, e in cov:
                ov += max(0, min(e, ch.q_end) - max(s, ch.q_start))
            if ov > 0.5 * (ch.q_end - ch.q_start):
                continue
            out.append(ch)
            cov.extend(self._anchor_cover(ch, qlen))
        return out

    def _assemble(self, plans) -> list[Alignment]:
        by_query: dict[str, list[Alignment]] = {}
        alns: list[Alignment] = []
        for qname, qlen, ch, skeleton, aq0, at0, rank in plans:
            parts: list[tuple[int, int]] = []
            for item in skeleton:
                if item[0] == "cig":
                    parts.append(item[1])
                else:
                    w = item[1]
                    if w.result:
                        parts.extend(w.result)
            core = _merge_cigar(parts)
            q_consumed = sum(l for op, l in core if op in (M, I))
            # oriented clip lengths
            left = aq0
            right = qlen - left - q_consumed
            if right < 0:
                continue
            cigar = _merge_cigar(
                ([(S, left)] if left else []) + core + ([(S, right)] if right else []))
            ref_idx, local = self.index.global_to_local(np.array([at0]))
            ref_id = int(ref_idx[0])
            a = Alignment(
                qname=qname, ref_name=self.names[ref_id], ref_id=ref_id,
                pos=int(local[0]), strand=ch.strand,
                mapq=60 if rank == 0 else 50,
                cigar=cigar, score=ch.score,
                is_supplementary=rank > 0, qlen=qlen,
                q_start=left, q_end=left + q_consumed)
            alns.append(a)
            by_query.setdefault(qname, []).append(a)
        return alns

    # --- inversion rescue (AlignConfig.inv_rescue) ----------------------
    _RESCUE_GAP = 30          # merge events within this ref gap into a run
    _RESCUE_MIN_SPAN = 35     # run ref span floor (bp)
    _RESCUE_MIN_EVENTS = 8
    _RESCUE_MARGIN = 20       # run extension on both sides
    _RESCUE_MAX_SPAN = 4096
    _RESCUE_SMALL_INDEL = 15  # indels ≤ this are soup events; larger break runs

    def _soup_runs(self, a: Alignment, qc: np.ndarray, tc: np.ndarray):
        """Dense mismatch/small-indel windows of one alignment.

        Returns [(r0, r1, q0, q1)] — ref coords local to the target, query
        coords in the alignment's orientation (clips included).  A small
        inversion chained straight through aligns as ~0.6+ events/bp
        against ≲0.01 (HiFi/contig) background, so a density trigger with a
        real-indel barrier finds exactly the inverted windows.  The
        mismatch scan is one vectorized gather over the M columns (this
        runs on EVERY alignment — the per-op python loop it replaces cost
        ~20% of warm read-alignment wall)."""
        cig = np.asarray(a.cigar, np.int64)
        ops, lens = cig[:, 0], cig[:, 1]

        def _offsets():
            cr = ((ops == M) | (ops == D)) * lens
            cq = ((ops == M) | (ops == I) | (ops == S)) * lens
            r0s = a.pos + np.concatenate([[0], np.cumsum(cr)[:-1]])
            q0s = np.concatenate([[0], np.cumsum(cq)[:-1]])
            return r0s, q0s

        from .native import get_lib
        lib = get_lib()
        if lib is not None and hasattr(lib, "soup_runs"):
            max_out = 64
            r0_arr = np.empty(max_out, np.int64)
            r1_arr = np.empty(max_out, np.int64)
            n = lib.soup_runs(np.ascontiguousarray(cig.reshape(-1)),
                              len(ops), a.pos,
                              np.ascontiguousarray(qc, np.int8), len(qc),
                              np.ascontiguousarray(tc, np.int8), len(tc),
                              self._RESCUE_GAP, self._RESCUE_MIN_SPAN,
                              self._RESCUE_MIN_EVENTS,
                              float(self.cfg.inv_rescue_density),
                              self._RESCUE_SMALL_INDEL,
                              self._RESCUE_MAX_SPAN, self._RESCUE_MARGIN,
                              r0_arr, r1_arr, max_out)
            if n == 0:
                return []
            r0s, q0s = _offsets()
            runs = []
            for i in range(int(n)):
                r0, r1 = int(r0_arr[i]), int(r1_arr[i])
                q0 = _ref_to_query(ops, lens, r0s, q0s, r0)
                q1 = _ref_to_query(ops, lens, r0s, q0s, r1)
                if q1 - q0 >= self._RESCUE_MIN_SPAN:
                    runs.append((r0, r1, q0, q1))
            return runs
        r0s, q0s = _offsets()
        # per-M-run slice compares (no index-array materialization: two
        # int8 slices per run instead of building ~qlen int64 gathers —
        # this runs on EVERY alignment)
        m_sel = (ops == M) & (lens > 0)
        events_list: list[np.ndarray] = []
        for i in np.nonzero(m_sel)[0]:
            r0, q0, ln = int(r0s[i]), int(q0s[i]), int(lens[i])
            mm = np.nonzero(qc[q0:q0 + ln] != tc[r0:r0 + ln])[0]
            if len(mm):
                events_list.append(mm + r0)
        ind_sel = ((ops == I) | (ops == D)) & (lens > 0) \
            & (lens <= self._RESCUE_SMALL_INDEL)
        if ind_sel.any():
            events_list.append(r0s[ind_sel])
        barriers = r0s[((ops == I) | (ops == D))
                       & (lens > self._RESCUE_SMALL_INDEL)].tolist()
        if not events_list:
            return []
        ev = np.sort(np.concatenate(events_list))
        # cheap reject: without MIN_EVENTS events inside some MIN_SPAN-ish
        # window nothing can trigger (true for almost every alignment)
        k = self._RESCUE_MIN_EVENTS
        if len(ev) < k or not (
                (ev[k - 1:] - ev[:len(ev) - k + 1])
                <= self._RESCUE_GAP * (k - 1)).any():
            return []
        # split runs at gaps and at real-indel barriers
        cut = np.diff(ev) > self._RESCUE_GAP
        if barriers:
            bar = np.asarray(barriers, np.int64)
            between = (np.searchsorted(bar, ev[:-1], "right")
                       != np.searchsorted(bar, ev[1:], "right"))
            cut |= between
        starts = np.concatenate([[0], np.nonzero(cut)[0] + 1])
        stops = np.concatenate([np.nonzero(cut)[0] + 1, [len(ev)]])
        runs = []
        t_end = a.pos + int((((ops == M) | (ops == D)) * lens).sum())
        for s, e in zip(starts, stops):
            lo, hi = int(ev[s]), int(ev[e - 1]) + 1
            n, span = e - s, hi - lo
            if (span < self._RESCUE_MIN_SPAN or n < self._RESCUE_MIN_EVENTS
                    or span > self._RESCUE_MAX_SPAN
                    or n / span < self.cfg.inv_rescue_density):
                continue
            # margin scales with span: margins are CLEAN forward sequence
            # that mismatches when the window is reverse-complemented, so
            # a fixed 20bp margin sinks a 60-90bp inversion below the
            # acceptance floor (margin cost ≈ 2.5/bp vs 0.7·span budget)
            m = min(self._RESCUE_MARGIN, max(3, span // 12))
            r0 = max(lo - m, a.pos)
            r1 = min(hi + m, t_end)
            q0 = _ref_to_query(ops, lens, r0s, q0s, r0)
            q1 = _ref_to_query(ops, lens, r0s, q0s, r1)
            if q1 - q0 >= self._RESCUE_MIN_SPAN:
                runs.append((r0, r1, q0, q1))
        return runs

    def _inv_rescue(self, alns: list[Alignment],
                    query_seqs: dict[str, str]) -> list[Alignment]:
        """Re-align soup windows reverse-complemented; emit winners as
        inverted supplementary alignments (config.AlignConfig.inv_rescue)."""
        from .ops.banded_align import banded_align_cigars
        from .ops.pack import pad_codes
        cand = []          # (aln, qc_aln, r0, r1, q0, q1, off)
        qc_cache: dict[tuple[str, int], np.ndarray] = {}
        for a in alns:
            key = (a.qname, a.strand)
            qc = qc_cache.get(key)
            if qc is None:
                qc = encode_seq(query_seqs[a.qname])
                if a.strand == -1:
                    qc = revcomp_codes(qc)
                qc_cache[key] = qc
            tc = self.ref_codes[a.ref_name]
            for r0, r1, q0, q1 in self._soup_runs(a, qc, tc):
                cand.append((a, qc, r0, r1, q0, q1))
        if not cand:
            return []
        # one DP batch per size bucket; rows alternate (rc, fwd)
        by_bucket: dict[int, list[int]] = {}
        for i, (_a, _qc, r0, r1, q0, q1) in enumerate(cand):
            by_bucket.setdefault(_bucket(max(r1 - r0, q1 - q0)), []).append(i)
        out: list[Alignment] = []
        for nb, idxs in by_bucket.items():
            qs, ts = [], []
            for i in idxs:
                a, qc, r0, r1, q0, q1 = cand[i]
                qseg = qc[q0:q1]
                tseg = self.ref_codes[a.ref_name][r0:r1]
                qs.append(revcomp_codes(qseg))
                ts.append(tseg)
                qs.append(qseg)
                ts.append(tseg)
            q_pad, qlen = pad_codes(qs, pad_to=nb)
            t_pad, tlen = pad_codes(ts, pad_to=nb)
            q_pad, t_pad, qlen, tlen, _B = pad_batch_pow2(
                q_pad, t_pad, qlen, tlen)
            cigs = banded_align_cigars(q_pad, t_pad, qlen, tlen,
                                       W=256, d_lo=-128, scores=self.scores)
            for row, i in enumerate(idxs):
                a, qc, r0, r1, q0, q1 = cand[i]
                rc_cig, fwd_cig = cigs[2 * row], cigs[2 * row + 1]
                sc_rc = _cigar_score(rc_cig, qs[2 * row], ts[2 * row],
                                     self.scores)
                sc_fwd = _cigar_score(fwd_cig, qs[2 * row + 1],
                                      ts[2 * row + 1], self.scores)
                # min of the two spans: an inversion with an interior
                # deletion matches over the shorter side and pays one gap
                span = min(q1 - q0, r1 - r0)
                floor = self.cfg.inv_rescue_min_score_frac \
                    * self.scores.match * span
                if not (sc_rc > sc_fwd + 10 and sc_rc >= floor):
                    continue
                # the rescued segment is the revcomp of the parent window;
                # in the new alignment's orientation (reverse of the
                # parent's) query offset x maps to qlen - x
                left_new = a.qlen - q1
                right_new = q0
                cigar = _merge_cigar(
                    ([(S, left_new)] if left_new else [])
                    + [(op, ln) for op, ln in rc_cig]
                    + ([(S, right_new)] if right_new else []))
                out.append(Alignment(
                    qname=a.qname, ref_name=a.ref_name, ref_id=a.ref_id,
                    pos=r0, strand=-a.strand, mapq=50, cigar=cigar,
                    score=float(sc_rc), is_supplementary=True, qlen=a.qlen,
                    q_start=left_new, q_end=left_new + (q1 - q0)))
        # dedupe: a query aligned twice over one region (primary + a
        # fragment supplementary) rescues overlapping inverted segments
        # whose coordinate skew downstream walks read as extra indels —
        # keep the best-scoring segment per overlapping ref region
        if len(out) > 1:
            out.sort(key=lambda a: -a.score)
            kept: list[Alignment] = []
            for a in out:
                dup = False
                for b in kept:
                    if a.qname == b.qname and a.ref_id == b.ref_id:
                        ov = min(a.t_end(), b.t_end()) - max(a.pos, b.pos)
                        if ov >= 0.5 * (a.t_end() - a.pos):
                            dup = True
                            break
                if not dup:
                    kept.append(a)
            out = kept
        if out:
            log.info("inversion rescue: %d inverted segments from %d "
                     "soup windows", len(out), len(cand))
        return out

    def to_bam_records(self, alns: list[Alignment],
                       query_seqs: dict[str, str]) -> list[BamRecord]:
        """Alignments → BamRecords with SA tags (split-read linkage)."""
        by_query: dict[str, list[Alignment]] = {}
        for a in alns:
            by_query.setdefault(a.qname, []).append(a)
        recs = []
        for a in alns:
            seq = query_seqs[a.qname]
            if a.strand == -1:
                seq = decode_codes(revcomp_codes(encode_seq(seq)))
            flag = (FREVERSE if a.strand == -1 else 0) | (
                FSUPPLEMENTARY if a.is_supplementary else 0)
            sa_parts = []
            for o in by_query[a.qname]:
                if o is a:
                    continue
                sa_parts.append(
                    f"{o.ref_name},{o.pos + 1},{'-' if o.strand == -1 else '+'},"
                    f"{o.cigar_string()},{o.mapq},0")
            tags = {"SA": ";".join(sa_parts) + ";"} if sa_parts else {}
            recs.append(BamRecord(
                name=a.qname, flag=flag, ref_id=a.ref_id, pos=a.pos,
                mapq=a.mapq,
                cigar=np.array(a.cigar, np.int64).reshape(-1, 2),
                seq=seq, qual=None, tags=tags))
        recs.sort(key=lambda r: (r.ref_id, r.pos))
        return recs
