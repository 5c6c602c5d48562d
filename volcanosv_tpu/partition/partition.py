"""K-mer haplotype partitioning of reads (SURVEY.md §7 step 5).

Replaces the reference's L2 script chain (unphased_reads_assignment_kmer_
norm.py → bamtoseq/HashSeq/prepare_info_v1/count_kmer_v1/split_hash_by_hp/
get_raw_kmer_overlap_count_unphased_est_pbs_v1.py), whose hot loops are
pure-Python string/Counter work:

* phased reads carry (hap, phase-block) from the phaser (HP/PS equivalent)
* each unphased read is routed to its 2 nearest phase blocks by interval
  distance (prepare_info_v1.py:95-133)
* per-(block,hap) dense k-mer count tables (k=12 → 4^12 tables) are built
  on device by scatter-add (count_kmer_v1.py equivalent)
* the 4-way unique-k-mer overlap vote runs as batched gathers over the
  tables (get_raw_kmer_overlap…py:43-71); scores are L2-normalized, a
  global (1 - sig_level) quantile sets the confident-assignment cutoff:
  confident → argmax haplotype, else → both haplotypes of the argmax block
  (:156-182)

Output: read name → [haplotype names] with names PS<pb>_<start>_<end>_hp<h>
(General_Assembly_Workflow reformat naming), feeding the assembly farm.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..config import PartitionConfig
from ..ops.kmer import (count_kmers_dense, distinct_runs, kmer_hashes,
                        overlap_scores)
from ..ops.pack import encode_seq, pad_codes
from ..utils.logging import get_logger

log = get_logger("partition")

_CHUNK = 64          # unphased reads scored per device launch


def hap_name(block_id: int, start: int, end: int, hp: int) -> str:
    """PS<pb>_<start>_<end>_hp<h> (1-based coords, reference naming)."""
    return f"PS{block_id}_{start}_{end}_hp{hp}"


@dataclass
class PartitionResult:
    assignment: dict[str, list[str]]     # read name → [hap names]
    blocks: list[tuple[int, int, int]]   # (block_id, start, end) 1-based
    n_single: int = 0
    n_double: int = 0


def _pow2ceil(n: int, lo: int = 512) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _read_hashes(seqs: list[str], k: int):
    """Fixed (B=_CHUNK, L=pow2-bucket) shapes so the jitted kmer kernels
    compile once per bucket instead of once per chunk."""
    n_real = len(seqs)
    seqs = list(seqs) + [""] * (_CHUNK - n_real)      # pad batch dim
    codes = [encode_seq(s) for s in seqs]
    L = _pow2ceil(max((len(c) for c in codes), default=1))
    padded, lens = pad_codes(codes, pad_to=L)
    h, v = kmer_hashes(jnp.asarray(padded), k)
    # clip validity to actual lengths (device-side; lens is host int array)
    idx = jnp.arange(h.shape[1])[None, :]
    v = v & (idx < (jnp.asarray(lens)[:, None] - k + 1))
    return h, v, n_real


_FLAT = 1 << 21      # codes per device launch for table building


def build_hap_tables(hap_read_seqs: dict[str, list[str]], k: int,
                     ) -> dict[str, jnp.ndarray]:
    """Dense 4^k count table per haplotype from its phased reads.

    Reads are concatenated into one code stream with single-N separators
    (windows spanning a boundary contain the N and are masked invalid), then
    hashed/counted in fixed (1, _FLAT) chunks — exactly one compiled shape
    per kernel for the whole stage, whatever the read count.  Tables stay
    device-resident (67MB each at k=12); accumulation is a device add per
    chunk."""
    from ..ops.pack import CODE_N
    sep = np.full(1, CODE_N, np.int8)
    out = {}
    step = _FLAT - (k - 1)       # chunk overlap of k-1 → each window once
    for hap, seqs in hap_read_seqs.items():
        table = jnp.zeros(4**k, jnp.int32)
        if seqs:
            parts = []
            for s in seqs:
                parts.append(encode_seq(s))
                parts.append(sep)
            flat = np.concatenate(parts)
            for i in range(0, len(flat), step):
                chunk = flat[i:i + _FLAT]
                if len(chunk) < k:
                    break
                if len(chunk) < _FLAT:
                    chunk = np.concatenate(
                        [chunk, np.full(_FLAT - len(chunk), CODE_N, np.int8)])
                h, v = kmer_hashes(jnp.asarray(chunk[None, :]), k)
                table = table + count_kmers_dense(h, v, k)
        out[hap] = table
    return out


def nearest_blocks(read_iv: tuple[int, int],
                   blocks: list[tuple[int, int, int]], n: int = 2
                   ) -> list[int]:
    """Block ids of the n nearest blocks by interval distance
    (prepare_info_v1.py assign_unphased :95-133)."""
    s, e = read_iv
    dists = []
    for bid, bs, be in blocks:
        d = max(0, bs - e, s - be)
        dists.append((d, bid))
    dists.sort()
    return [bid for _, bid in dists[:n]]


def partition_reads(
    phased: dict[str, tuple[int, int]],        # read → (hap 1|2, block_id)
    unphased: dict[str, tuple[str, tuple[int, int]]],  # read → (seq, (s,e))
    phased_seqs: dict[str, str],
    blocks: list[tuple[int, int, int]],
    cfg: PartitionConfig,
) -> PartitionResult:
    """Assign every read to haplotype group(s)."""
    block_span = {bid: (s, e) for bid, s, e in blocks}

    def hname(bid: int, hp: int) -> str:
        s, e = block_span[bid]
        return hap_name(bid, s + 1, e + 1, hp)

    assignment: dict[str, list[str]] = {}
    hap_read_seqs: dict[str, list[str]] = {}
    for rname, (hp, bid) in phased.items():
        if bid not in block_span:
            continue
        hn = hname(bid, hp)
        assignment[rname] = [hn]
        seq = phased_seqs.get(rname)
        if seq and len(seq) >= cfg.min_read_len:
            hap_read_seqs.setdefault(hn, []).append(seq)

    if not unphased or not blocks:
        return PartitionResult(assignment, blocks)

    # device k-mer tables are 4^k int32 = 67 MB each at k=12 — one per
    # (block, hp) simultaneously resident grows with the number of phase
    # blocks (hundreds per chromosome at 50 Mb), so device memory would
    # grow with the genome.  Tables are built on demand per block-pair and
    # LRU-evicted (8 tables, 0.5 GB; the best size on an 80 GB card is
    # not measured); groups are processed in block order so neighboring
    # pairs reuse the cached tables.
    from collections import OrderedDict
    zero = jnp.zeros(4**cfg.k, jnp.int32)
    table_cache: OrderedDict[str, jnp.ndarray] = OrderedDict()
    _MAX_TABLES = 8

    def get_table(h: str) -> jnp.ndarray:
        t = table_cache.get(h)
        if t is None:
            seqs = hap_read_seqs.get(h)
            t = build_hap_tables({h: seqs}, cfg.k)[h] if seqs else zero
            table_cache[h] = t
            while len(table_cache) > _MAX_TABLES:
                table_cache.popitem(last=False)
        else:
            table_cache.move_to_end(h)
        return t

    # group unphased reads by candidate block pair
    groups: dict[tuple[int, int], list[str]] = {}
    for rname, (seq, iv) in unphased.items():
        if len(seq) < cfg.min_read_len or "N" in seq[:cfg.k]:
            pass
        nb = nearest_blocks(iv, blocks, cfg.n_nearest_blocks)
        if not nb:
            continue
        if len(nb) == 1:
            nb = [nb[0], nb[0]]
        groups.setdefault((nb[0], nb[1]), []).append(rname)

    all_scores: list[np.ndarray] = []
    all_names: list[str] = []
    all_haps: list[list[str]] = []
    for (b1, b2), rnames in sorted(groups.items()):
        haps = [hname(b1, 1), hname(b1, 2), hname(b2, 1), hname(b2, 2)]
        if b1 == b2:
            # single candidate block (e.g. a one-block chromosome):
            # duplicating the two tables would make NO k-mer unique
            # across the 4 slots and zero every score — vote 2-way with
            # empty tables in the duplicate slots instead
            t4_d = jnp.stack([get_table(haps[0]), get_table(haps[1]),
                              zero, zero])
        else:
            t4_d = jnp.stack([get_table(h) for h in haps])
        present = t4_d > 0
        u_d = present & (present.sum(0, keepdims=True) == 1)
        for i in range(0, len(rnames), _CHUNK):
            chunk = rnames[i:i + _CHUNK]
            seqs = [unphased[r][0] for r in chunk]
            h, v, n_real = _read_hashes(seqs, cfg.k)
            s, first, runlen = distinct_runs(h, v)
            sc = np.asarray(overlap_scores(s, first, runlen, t4_d, u_d))
            all_scores.append(sc[:n_real])
            all_names.extend(chunk)
            all_haps.extend([haps] * len(chunk))

    if not all_names:
        return PartitionResult(assignment, blocks)

    X = np.concatenate(all_scores).astype(np.float64)
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    Xn = X / np.maximum(norms, 1e-12)
    cutoff = float(np.quantile(Xn.flatten(), 1 - cfg.sig_level))
    n_single = n_double = 0
    pair_of = {0: (0, 1), 1: (0, 1), 2: (2, 3), 3: (2, 3)}
    for i, rname in enumerate(all_names):
        row = Xn[i]
        j = int(np.argmax(row))
        if row[j] >= cutoff and norms[i] > 0:
            picks = [j]
            n_single += 1
        else:
            picks = list(pair_of[j])
            n_double += 1
        assignment[rname] = [all_haps[i][p] for p in picks]
    log.info("partition: %d single, %d double (%.1f%% single)",
             n_single, n_double, 100 * n_single / max(n_single + n_double, 1))
    return PartitionResult(assignment, blocks, n_single, n_double)
