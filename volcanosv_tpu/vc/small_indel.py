"""Small-indel (2–49bp) diploid calling from haplotype contig alignments.

Replaces the reference's small-indel chain (volcanosv-vc-small-indel.py):
htsbox `pileup -q5 -ecf ref hp1.bam hp2.bam -w 20` (pileup.c:126-176) +
`dipcall-aux.js vcfpair` (GT pairing) + multi-ALT split (reformat_dipcall.py)
+ 2–49bp awk size filter + 15-mer read-support FP filter
(check_reads_kmer_support.py, defaults -k 15 -rt 0.3 -ms 5).

Design differences (not a port): the haplotype contigs are
*consensus* sequences, so per-column pileup over one haploid BAM reduces to
reading variants straight off each contig→ref alignment CIGAR — a vectorized
O(aligned-bases) numpy pass per contig instead of htsbox's per-column C
loop.  The k-mer support filter batches all variants' read-window 15-mer
counting through shared rolling-hash kernels (ops/kmer.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import PipelineConfig, SmallIndelConfig
from ..io.bam import BamRecord
from ..io.vcf import VcfRecord
from ..ops.pack import encode_seq
from ..utils.logging import get_logger
from ..ops.kmer import kmer_hashes_np
from .large_indel import phase_records

log = get_logger("small_indel")

_M, _I, _D, _S, _H, _EQ, _X = 0, 1, 2, 4, 5, 7, 8
_CONSUMES_REF = (_M, _D, _EQ, _X)
_CONSUMES_QUERY = (_M, _I, _S, _EQ, _X)


@dataclass
class HapVariant:
    pos: int              # 0-based ref position of the anchor base
    ref: str              # VCF REF (anchor base included for indels)
    alt: str              # VCF ALT
    tig: str
    tig_start: int        # contig coordinate of variant start
    tig_end: int
    strand: str
    mapq: int
    context: str          # contig sequence window around the allele

    @property
    def is_snp(self) -> bool:
        return len(self.ref) == 1 and len(self.alt) == 1

    @property
    def indel_size(self) -> int:
        return abs(len(self.alt) - len(self.ref))


def _variants_from_alignment(rec: BamRecord, ref_seq: str,
                             cfg: SmallIndelConfig) -> list[HapVariant]:
    """Walk one contig→ref alignment, emitting SNPs and indels ≤ max_size.

    Equivalent information content to one htsbox pileup column stream over a
    haploid BAM (pileup.c:126-176) because the contig is a consensus."""
    out: list[HapVariant] = []
    seq = rec.seq
    if not seq:
        return out
    strand = "-" if rec.is_reverse else "+"
    w = cfg.context
    rpos = rec.pos
    qpos = 0
    L = len(ref_seq)
    ops = rec.cigar[:, 0]
    lens = rec.cigar[:, 1]
    ref_codes_cache = None
    for op, ln in zip(ops, lens):
        ln = int(ln)
        if op in (_M, _EQ, _X):
            if op != _EQ:
                # vectorized mismatch scan over the block
                if ref_codes_cache is None:
                    ref_codes_cache = encode_seq(ref_seq)
                    seq_codes = encode_seq(seq)
                rb = ref_codes_cache[rpos:rpos + ln]
                qb = seq_codes[qpos:qpos + ln]
                n = min(len(rb), len(qb))
                mism = np.nonzero((rb[:n] != qb[:n]) & (rb[:n] < 4)
                                  & (qb[:n] < 4))[0]
                for i in mism:
                    p, q = rpos + int(i), qpos + int(i)
                    out.append(HapVariant(
                        pos=p, ref=ref_seq[p], alt=seq[q], tig=rec.name,
                        tig_start=q, tig_end=q + 1, strand=strand,
                        mapq=rec.mapq,
                        context=seq[max(0, q - w):q + 1 + w]))
            rpos += ln
            qpos += ln
        elif op == _I:
            if 1 <= ln <= cfg.max_size and 0 < rpos <= L:
                p, q = rpos - 1, qpos
                ins = seq[q:q + ln]
                out.append(HapVariant(
                    pos=p, ref=ref_seq[p], alt=ref_seq[p] + ins,
                    tig=rec.name, tig_start=q, tig_end=q + ln,
                    strand=strand, mapq=rec.mapq,
                    context=seq[max(0, q - w):q + ln + w]))
            qpos += ln
        elif op == _D:
            if 1 <= ln <= cfg.max_size and 0 < rpos and rpos + ln <= L:
                p, q = rpos - 1, qpos
                out.append(HapVariant(
                    pos=p, ref=ref_seq[p:p + ln + 1], alt=ref_seq[p],
                    tig=rec.name, tig_start=max(0, q - 1), tig_end=q + 1,
                    strand=strand, mapq=rec.mapq,
                    context=seq[max(0, q - w):q + w]))
            rpos += ln
        elif op == _S:
            qpos += ln
        # H/N/P consume nothing we track
    return out


VarKey = tuple[int, str]            # (anchor pos, kind ∈ {'S','I','D'})


def _kind(v: HapVariant) -> str:
    if v.is_snp:
        return "S"
    return "I" if len(v.alt) > len(v.ref) else "D"


def extract_hap_variants(records: list[BamRecord], ref_seq: str, hap: str,
                         cfg: SmallIndelConfig
                         ) -> tuple[dict[VarKey, HapVariant], np.ndarray,
                                    dict[VarKey, HapVariant]]:
    """All variants of one haplotype + its ref-coverage mask + tie
    candidates (50/50 contig splits for the caller's read arbitration).

    htsbox pileup column semantics (pileup.c:126-176): a column carries a
    base allele AND an indel allele independently, so variants key on
    (pos, kind) — a SNP and an adjacent-anchored indel at one position
    coexist.  Disagreeing overlapping contigs of the SAME haplotype resolve
    jointly: the majority allele among covering contigs wins, and an allele
    asserted by ≤ half of the covering contigs is ambiguous and dropped
    (one contig says variant, the other says ref → no call, like a 50/50
    pileup column)."""
    L = len(ref_seq)
    cov = np.zeros(L + 1, np.int32)
    # (pos, kind) → (ref, alt) → [n_contigs, best HapVariant]
    support: dict[VarKey, dict[tuple[str, str], list]] = {}
    recs = [r for r in records
            if hap in r.name and not r.is_unmapped
            and not r.is_secondary and r.mapq >= cfg.min_mapq]
    # inversion spans: a contig's minority-strand segments mark inverted
    # regions — the majority-strand alignment crosses them as mismatch/
    # small-indel soup whose 'variants' are artifacts of linear alignment
    # against inverted sequence, not real small indels (the htsbox pileup
    # has the same blindspot; svim-asm owns INV calling,
    # SVIM_inter.py:62-340).  Calls inside these spans are dropped.
    strand_len: dict[str, dict[int, int]] = {}
    for r in recs:
        d = strand_len.setdefault(r.name, {1: 0, -1: 0})
        d[-1 if r.is_reverse else 1] += max(r.reference_end - r.pos, 0)
    inv_spans: list[tuple[int, int]] = []
    for r in recs:
        d = strand_len[r.name]
        dom = 1 if d[1] >= d[-1] else -1
        if (-1 if r.is_reverse else 1) != dom:
            inv_spans.append((r.pos - 10, r.reference_end + 10))

    def in_inv(pos: int) -> bool:
        return any(a <= pos <= b for a, b in inv_spans)

    for rec in recs:
        if rec.is_supplementary and strand_len[rec.name] and in_inv(rec.pos):
            # the minority-strand segment itself: its variants live in
            # inverted coordinates; skip (and don't count coverage twice)
            d = strand_len[rec.name]
            if (-1 if rec.is_reverse else 1) != (1 if d[1] >= d[-1] else -1):
                continue
        cov[rec.pos] += 1
        cov[min(rec.reference_end, L)] -= 1
        for v in _variants_from_alignment(rec, ref_seq, cfg):
            if inv_spans and in_inv(v.pos):
                continue
            d = support.setdefault((v.pos, _kind(v)), {})
            e = d.get((v.ref, v.alt))
            if e is None:
                d[(v.ref, v.alt)] = [1, v]
            else:
                e[0] += 1
                if v.mapq > e[1].mapq:
                    e[1] = v
    coverage = np.cumsum(cov[:-1])
    by_key: dict[VarKey, HapVariant] = {}
    ties: dict[VarKey, HapVariant] = {}
    for key, alleles in support.items():
        n, v = max(alleles.values(),
                   key=lambda e: (e[0], e[1].mapq,
                                  len(e[1].alt) + len(e[1].ref)))
        pos = key[0]
        n_cover = int(coverage[pos]) if 0 <= pos < L else n
        if 2 * n > n_cover:
            by_key[key] = v
        elif 2 * n == n_cover and not v.is_snp:
            # exact split between overlapping same-hap contigs (one lost
            # the allele to consensus) — the caller resolves with reads
            ties[key] = v
    return by_key, coverage > 0, ties


def pair_hap_variants(chrom: str,
                      h1: dict[VarKey, HapVariant],
                      h2: dict[VarKey, HapVariant],
                      cov1: np.ndarray, cov2: np.ndarray
                      ) -> list[VcfRecord]:
    """dipcall-aux.js vcfpair equivalent: join per-hap variant streams into
    phased diploid records; multi-ALT sites are split into two records
    (reformat_dipcall.py:9-28).  Streams join on (pos, kind), so a SNP and
    an indel anchored at one position each produce their own record."""
    out: list[VcfRecord] = []
    counter = {}

    def emit(v: HapVariant, gt: str) -> None:
        vtype = ("SNP" if v.is_snp else
                 "INS" if len(v.alt) > len(v.ref) else "DEL")
        n = counter.get(vtype, 0) + 1
        counter[vtype] = n
        info = {"TIG_REGION": f"{v.tig}:{v.tig_start+1}-{v.tig_end}",
                "QUERY_STRAND": v.strand, "CONTEXT": v.context}
        if vtype != "SNP":
            info["SVTYPE"] = vtype
            info["SVLEN"] = (len(v.alt) - len(v.ref) if vtype == "INS"
                             else len(v.ref) - len(v.alt))
        out.append(VcfRecord(
            chrom=chrom, pos=v.pos + 1, id=f"{chrom}-{vtype}-{n}-{v.pos+1}",
            ref=v.ref, alt=v.alt, qual="30", gt=gt, info=info))

    for key in sorted(set(h1) | set(h2)):
        pos = key[0]
        v1, v2 = h1.get(key), h2.get(key)
        if v1 and v2:
            if (v1.ref, v1.alt) == (v2.ref, v2.alt):
                emit(v1, "1|1")
            else:                      # het-alt: split multi-ALT row
                emit(v1, "1|0")
                emit(v2, "0|1")
        elif v1:
            # hap2 covered & agrees with ref → 1|0 ; uncovered → still 1|0
            # but the call has single-hap evidence (vcfpair marks '.').
            gt = "1|0" if pos < len(cov2) and cov2[pos] else "1|."
            emit(v1, gt)
        else:
            gt = "0|1" if pos < len(cov1) and cov1[pos] else ".|1"
            emit(v2, gt)
    return out


def size_filter(records: list[VcfRecord], cfg: SmallIndelConfig,
                keep_snps: bool = False) -> list[VcfRecord]:
    """awk 2–49bp band (volcanosv-vc-small-indel.py filter_vcf_by_size_bed:35-68)."""
    kept = []
    for r in records:
        sz = abs(len(r.alt) - len(r.ref))
        if sz == 0:
            if keep_snps:
                kept.append(r)
        elif cfg.min_size <= sz <= cfg.max_size:
            kept.append(r)
    return kept


# ---------------------------------------------------------------------------
# k-mer read-support FP filter (check_reads_kmer_support.py:184-304)
# ---------------------------------------------------------------------------

def _aligned_pairs_np(rec: BamRecord):
    cigar = rec.cigar
    ops, lens = cigar[:, 0], cigar[:, 1].astype(np.int64)
    cr = np.isin(ops, _CONSUMES_REF) * lens
    cq = np.isin(ops, _CONSUMES_QUERY) * lens
    ref0 = rec.pos + np.concatenate([[0], np.cumsum(cr)[:-1]])
    q0 = np.concatenate([[0], np.cumsum(cq)[:-1]])
    m = np.isin(ops, (_M, _EQ, _X)) & (lens > 0)
    if not m.any():
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ls = lens[m]
    base = np.repeat(np.cumsum(ls) - ls, ls)
    offs = np.arange(int(ls.sum())) - base
    return np.repeat(ref0[m], ls) + offs, np.repeat(q0[m], ls) + offs


def kmer_support_filter(records: list[VcfRecord],
                        reads_records: list[BamRecord],
                        cfg: SmallIndelConfig) -> list[VcfRecord]:
    """Drop calls whose contig CONTEXT k-mers are unsupported by the reads.

    For each call: reconstruct each overlapping read's substring across
    ref window [pos-20, pos+70) (get_seq:75-99), pool their 15-mers, and
    fail the call if > max_bad_kmer_ratio of its CONTEXT k-mers have
    ≤ min_kmer_support read occurrences (filter_indel:184-304)."""
    if not records:
        return records
    k = cfg.kmer_k
    starts = np.array([r.pos - 1 - cfg.region_left for r in records], np.int64)
    ends = np.array([r.pos - 1 + cfg.region_right for r in records], np.int64)
    order = np.argsort(starts, kind="stable")
    sorted_starts = starts[order]
    # per-variant k-mer hash multiset from reads, pooled then counted once
    var_hashes: list[list[np.ndarray]] = [[] for _ in records]
    for rec in reads_records:
        if rec.is_unmapped or rec.is_secondary or not rec.seq:
            continue
        ref_idx, read_idx = _aligned_pairs_np(rec)
        if len(ref_idx) == 0:
            continue
        lo = int(np.searchsorted(sorted_starts, rec.pos - cfg.region_right))
        hi = int(np.searchsorted(sorted_starts, rec.reference_end))
        if lo >= hi:
            continue
        codes = encode_seq(rec.seq)
        for oi in range(lo, hi):
            vi = int(order[oi])
            a, b = int(starts[vi]), int(ends[vi])
            i0 = int(np.searchsorted(ref_idx, a))
            i1 = int(np.searchsorted(ref_idx, b))
            if i1 - i0 < k:            # read covers too little of the window
                continue
            qs, qe = int(read_idx[i0]), int(read_idx[i1 - 1]) + 1
            h, v = kmer_hashes_np(codes[qs:qe], k)
            if v.any():
                var_hashes[vi].append(h[v])
    kept = []
    n_drop = 0
    for vi, r in enumerate(records):
        ctx = str(r.info.get("CONTEXT", ""))
        ch, cv = kmer_hashes_np(encode_seq(ctx), k)
        ch = ch[cv]
        if len(ch) == 0:
            kept.append(r)
            continue
        if var_hashes[vi]:
            pool = np.concatenate(var_hashes[vi])
            uh, cnt = np.unique(pool, return_counts=True)
            idx = np.searchsorted(uh, ch)
            idx = np.clip(idx, 0, len(uh) - 1)
            support = np.where(uh[idx] == ch, cnt[idx], 0)
        else:
            support = np.zeros(len(ch), np.int64)
        bad = (support <= cfg.min_kmer_support).mean()
        if bad > cfg.max_bad_kmer_ratio:
            n_drop += 1
        else:
            kept.append(r)
    log.info("kmer support filter: %d/%d dropped", n_drop, len(records))
    return kept


def call_small_indels(
    chrom: str,
    contig_records: list[BamRecord],
    ref_seq: str,
    cfg: PipelineConfig,
    reads_records: list[BamRecord] | None = None,
    keep_snps: bool = False,
    read_hp: dict[str, int] | None = None,
) -> list[VcfRecord]:
    """Full small-indel calling for one chromosome (driver parity:
    volcanosv-vc-small-indel.py main).  read_hp (read → haplotype) enables
    phase-aware 1|1→het arbitration like the large path."""
    sic = cfg.small_indel
    h1, cov1, tie1 = extract_hap_variants(contig_records, ref_seq, "hp1", sic)
    h2, cov2, tie2 = extract_hap_variants(contig_records, ref_seq, "hp2", sic)
    ep = el = ed = None
    ev_names: list[str] = []
    if reads_records is not None:
        ev_p, ev_l, ev_d, ev_n = [], [], [], []
        for rec in reads_records:
            if rec.is_unmapped or rec.is_secondary or rec.is_supplementary:
                continue
            cig = np.asarray(rec.cigar)
            if len(cig) == 0:
                continue
            ops, lens = cig[:, 0], cig[:, 1].astype(np.int64)
            cr = np.isin(ops, (_M, _D, _EQ, _X)) * lens
            r0s = rec.pos + np.concatenate([[0], np.cumsum(cr)[:-1]])
            ind = np.isin(ops, (_I, _D)) & (lens > 0)
            if not ind.any():
                continue
            ev_p.append(r0s[ind])
            ev_l.append(lens[ind])
            ev_d.append(ops[ind] == _D)
            ev_n.append(np.full(int(ind.sum()), len(ev_names), np.int64))
            ev_names.append(rec.name)
        if ev_p:
            ep = np.concatenate(ev_p)
            el = np.concatenate(ev_l)
            ed = np.concatenate(ev_d)
            en = np.concatenate(ev_n)
            order = np.argsort(ep, kind="stable")
            ep, el, ed, en = ep[order], el[order], ed[order], en[order]

    def _event_window(pos: int, kind: str, sz: int):
        lo = int(np.searchsorted(ep, pos - 20))
        hi = int(np.searchsorted(ep, pos + 20, "right"))
        sl, sd = el[lo:hi], ed[lo:hi]
        ok = (sd == (kind == "D")) & \
             (np.minimum(sl, sz) / np.maximum(sl, sz) >= 0.5)
        return ok, lo

    if ep is not None and (tie1 or tie2):
        # arbitrate 50/50 contig splits with read-level indel events: a
        # real het indel has carrier reads; a consensus artifact does not
        for ties, h in ((tie1, h1), (tie2, h2)):
            for key, v in ties.items():
                ok, _lo = _event_window(key[0], key[1], v.indel_size)
                if int(ok.sum()) >= 3:
                    h[key] = v
    log.info("%s: %d hp1 variants, %d hp2 variants", chrom, len(h1), len(h2))
    records = pair_hap_variants(chrom, h1, h2, cov1, cov2)
    records = size_filter(records, sic, keep_snps=keep_snps)
    if reads_records is not None:
        records = kmer_support_filter(records, reads_records, sic)
    if ep is not None and read_hp:
        # phase-aware GT arbitration (mirrors vc.gt_correction.
        # phase_aware_gt at small-indel scale): a 1|1 whose phased carrier
        # reads sit on ONE haplotype is a bin-leak het
        n_down = 0
        for r in records:
            if r.gt not in ("1|1", "1/1") or r.svtype not in ("INS", "DEL"):
                continue
            sz = abs(len(r.alt) - len(r.ref))
            kind = "I" if len(r.alt) > len(r.ref) else "D"
            ok, lo = _event_window(r.pos - 1, kind, sz)
            carriers = {ev_names[int(en[lo + i])]
                        for i in np.nonzero(ok)[0]}
            blocks: dict[int, list[int]] = {}
            for n in carriers:
                hb = read_hp.get(n)
                if hb is None:
                    continue
                h, b = hb if isinstance(hb, tuple) else (hb, 0)
                blocks.setdefault(b, []).append(h)
            if not blocks:
                continue
            hs = max(blocks.values(), key=len)
            n1 = sum(1 for h in hs if h == 1)
            n2 = sum(1 for h in hs if h == 2)
            tot = n1 + n2
            if tot < max(6, 0.5 * len(carriers)):
                continue
            if min(n1, n2) <= max(1, 0.06 * tot):
                r.gt = "1|0" if n1 >= n2 else "0|1"
                n_down += 1
        if n_down:
            log.info("%s: phase-aware small-indel GT downgraded %d",
                     chrom, n_down)
    return phase_records(records)
