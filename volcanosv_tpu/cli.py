"""Command-line drivers — parity with the reference's CLI surface.

Reference CLIs (README.md:97-423): volcanosv-asm.py, volcanosv-vc-large-indel.py,
volcanosv-vc-small-indel.py, volcanosv-vc-complex-sv.py, Utils/Merge_VCF.py.
Here they are subcommands of one entry point:

    python -m volcanosv_tpu.cli sim            --out_dir sim/
    python -m volcanosv_tpu.cli asm            --ref ref.fa --fastq reads.fq --out_dir out/
    python -m volcanosv_tpu.cli vc-large-indel --ref ref.fa --contig contigs.fa --out_dir out/
    python -m volcanosv_tpu.cli vc-small-indel --ref ref.fa --contig contigs.fa --out_dir out/
    python -m volcanosv_tpu.cli vc-complex-sv  --ref ref.fa --contig contigs.fa --out_dir out/
    python -m volcanosv_tpu.cli merge-vcf      --out_vcf merged.vcf a.vcf b.vcf ...
    python -m volcanosv_tpu.cli run            --ref ref.fa --fastq reads.fq --out_dir out/

The `--contig` FASTAs use the reference's contig naming contract
(PS<pb>_<start>_<end>_hp{1,2}_<n>, i.e. the '-otherasm' entry:
volcanosv-vc-large-indel-otherasm.py README.md:397-410)."""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .config import PipelineConfig
from .utils.logging import get_logger, stage_timer

log = get_logger("cli")


# ---------------------------------------------------------------------------
# shared loading helpers
# ---------------------------------------------------------------------------

def _load_ref(path: str) -> dict[str, str]:
    from .io.fasta import read_fasta
    return read_fasta(path)


def _load_reads(args) -> dict[str, str]:
    """Read name → sequence from --fastq or --bam."""
    seqs: dict[str, str] = {}
    if getattr(args, "fastq", None):
        from .io.fastq import read_fastq
        for name, seq, _q in read_fastq(args.fastq):
            seqs[name] = seq
    elif getattr(args, "bam", None):
        from .io.bam import BamReader, scan_bam
        sc = scan_bam(args.bam)            # native parallel-inflate loader
        if sc is not None:
            return sc.read_seqs()
        with BamReader(args.bam) as br:
            for rec in br:
                if rec.seq and not rec.is_secondary and not rec.is_supplementary:
                    seqs[rec.name] = rec.seq
    return seqs


def _align_by_chrom(ref: dict[str, str], seqs: dict[str, str], preset: str):
    """Align sequences to ref; returns (records_by_chrom, aligner)."""
    from .aligner import Aligner
    from .config import AlignConfig
    aligner = Aligner(ref, AlignConfig.preset(preset))
    recs = aligner.to_bam_records(aligner.align(list(seqs.items())), seqs)
    by_chrom: dict[str, list] = {c: [] for c in ref}
    for r in recs:
        by_chrom[aligner.names[r.ref_id]].append(r)
    return by_chrom, aligner


def _align_by_chrom_sharded(ref, seqs, preset: str, out_dir: str, tag: str,
                            want: list[str] | None = None):
    """Query-sharded multi-process alignment: each process aligns a
    contiguous 1/P slice of the query set against the (identical) full
    reference index, then per-chromosome record lists are exchanged over
    the shared filesystem so this process receives the chromosomes in
    `want`.  Byte-identical record sets/order vs the single-process path
    (parallel.multiproc.exchange_by_chrom); single-process it IS the
    single-process path."""
    from .parallel import multiproc as mp
    if mp.n_processes() == 1:
        by_chrom, _ = _align_by_chrom(ref, seqs, preset)
        if want is not None:
            by_chrom = {c: by_chrom.get(c, []) for c in want}
        return by_chrom
    from .aligner import Aligner
    from .config import AlignConfig
    items = list(seqs.items())
    lo, hi = mp.shard_interval(len(items))
    aligner = Aligner(ref, AlignConfig.preset(preset))
    chunk = items[lo:hi]
    recs = aligner.to_bam_records(aligner.align(chunk), dict(chunk))
    local: dict[str, list] = {c: [] for c in ref}
    for r in recs:
        local[aligner.names[r.ref_id]].append(r)
    log.info("host %d/%d aligned queries [%d:%d) of %d (%s)",
             mp.process_id(), mp.n_processes(), lo, hi, len(items), tag)
    return mp.exchange_by_chrom(local, out_dir, tag,
                                want=want if want is not None else list(ref))


def _read_preset(dtype: str) -> str:
    return {"Hifi": "map-hifi", "CLR": "map-pb", "ONT": "map-ont"}[dtype]


def _maybe_reads_by_chrom(args, ref, want: list[str] | None = None):
    if not (getattr(args, "fastq", None) or getattr(args, "bam", None)):
        return None, {}
    read_seqs = _load_reads(args)
    by_chrom = _align_by_chrom_sharded(ref, read_seqs,
                                       _read_preset(args.dtype),
                                       args.out_dir, "reads", want=want)
    return by_chrom, read_seqs


def _vcf_out(out_dir: str, name: str, ref: dict[str, str], records) -> str:
    from .io.vcf import make_header, write_vcf
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    n = write_vcf(path, make_header({c: len(s) for c, s in ref.items()}),
                  records)
    log.info("wrote %d records → %s", n, path)
    return path


def _vcf_out_sharded(out_dir: str, name: str, ref: dict[str, str],
                     records) -> str:
    """Multi-process VCF output: each host writes its owned chromosomes'
    records as a part file, rank 0 merges them in process order — the
    reference's per-chromosome concat (volcanosv-vc-large-indel.py:266-278
    + Merge_VCF.py), replacing the round-2 bug where every host wrote the
    same final path.  Single-process: plain _vcf_out."""
    from .parallel import multiproc as mp
    if mp.n_processes() == 1:
        return _vcf_out(out_dir, name, ref, records)
    parts_dir = os.path.join(out_dir, "parts")
    os.makedirs(parts_dir, exist_ok=True)
    _vcf_out(parts_dir, f"{name}.p{mp.process_id()}.vcf", ref, records)
    mp.barrier(f"vcf:{name}")
    path = os.path.join(out_dir, name)
    if mp.is_rank0():
        from .io.vcf import merge_vcfs
        n = merge_vcfs([os.path.join(parts_dir, f"{name}.p{p}.vcf")
                        for p in range(mp.n_processes())], path)
        log.info("rank 0 merged %d records from %d parts → %s",
                 n, mp.n_processes(), path)
    mp.barrier(f"vcf-merged:{name}")
    return path


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_sim(args) -> int:
    """Synthesize ref + diploid SVs + reads (+ truth VCF) for testing."""
    from . import sim
    from .io.fasta import write_fasta
    from .io.fastq import write_fastq
    from .io.vcf import VcfRecord, make_header, write_vcf
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    ref = sim.random_genome(rng, args.length, n_chroms=args.chroms)
    if getattr(args, "n_tandem", 0) or getattr(args, "n_segdup", 0) \
            or getattr(args, "n_homopoly", 0):
        ref, feats = sim.implant_repeats(
            rng, ref, n_tandem=args.n_tandem, n_segdup=args.n_segdup,
            n_homopoly=args.n_homopoly)
        from .io.bed import write_bed
        write_bed(os.path.join(args.out_dir, "repeats.bed"),
                  [(c, s, e, kind) for c, fs in feats.items()
                   for kind, s, e in fs])
    hap1, hap2, truth = sim.implant_svs(
        rng, ref, n_del=args.n_del, n_ins=args.n_ins, n_inv=args.n_inv,
        n_dup=args.n_dup, min_len=args.min_len, max_len=args.max_len,
        n_clustered=getattr(args, "n_clustered", 0),
        n_nested=getattr(args, "n_nested", 0),
        n_small=getattr(args, "n_small", 0))
    # SNPs go in at REF coordinates BEFORE the translocation tail-swap (the
    # swap moves hap sequence between chromosome records but every allele
    # keeps its reference locus, so the truth coordinates stay valid)
    hap1, hap2, truth_snps = sim.implant_snps_ref(
        rng, ref, hap1, hap2, truth, rate=args.snp_rate)
    if getattr(args, "n_tra", 0):
        if args.chroms < 2:
            log.error("--n_tra requires --chroms >= 2")
            return 2
        truth += sim.implant_tra(rng, ref, hap1, hap2, truth)
    reads = sim.simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=args.coverage,
        read_len=args.read_len, sub_rate=args.err, indel_rate=args.err / 2)
    write_fasta(os.path.join(args.out_dir, "ref.fa"), ref)
    write_fastq(os.path.join(args.out_dir, "reads.fastq"),
                ((n, s, None) for n, s, *_ in reads))
    trecs = []
    for i, t in enumerate(truth):
        gt = "1|1" if t.gt == (1, 1) else ("1|0" if t.gt[0] else "0|1")
        if t.svtype == "BND":
            trecs.append(VcfRecord(
                chrom=t.chrom, pos=t.pos + 1, id=f"truth-{i}", ref="N",
                alt=f"N[{t.chrom2}:{t.pos2 + 1}[", gt=gt,
                info={"SVTYPE": "BND", "CHR2": t.chrom2,
                      "END": t.pos2 + 1}))
            continue
        trecs.append(VcfRecord(
            chrom=t.chrom, pos=t.pos + 1, id=f"truth-{i}", ref="N",
            alt=f"<{t.svtype}>", gt=gt,
            info={"SVTYPE": t.svtype, "SVLEN": t.svlen,
                  "END": t.pos + 1 + t.svlen}))
    write_vcf(os.path.join(args.out_dir, "truth.vcf"),
              make_header({c: len(s) for c, s in ref.items()}), trecs)
    # truth SNPs: GT encodes the carrying haplotype (1|0 = hap1, 0|1 =
    # hap2, 1/1 = hom) — the phasing switch-error gate's ground truth
    snp_recs = [VcfRecord(
        chrom=s.chrom, pos=s.pos + 1, id=f"tsnp-{i}", ref=s.ref, alt=s.alt,
        gt=("1/1" if s.hap == 0 else ("1|0" if s.hap == 1 else "0|1")))
        for i, s in enumerate(truth_snps)]
    order = {c: i for i, c in enumerate(ref)}
    snp_recs.sort(key=lambda r: (order[r.chrom], r.pos))
    write_vcf(os.path.join(args.out_dir, "truth_snps.vcf"),
              make_header({c: len(s) for c, s in ref.items()}), snp_recs)
    contigs = sim.contigs_from_haplotypes(hap1, hap2)
    write_fasta(os.path.join(args.out_dir, "true_contigs.fa"), contigs)
    log.info("sim → %s (%d reads, %d truth SVs)", args.out_dir,
             len(reads), len(truth))
    return 0


def _ckpt(args):
    from .utils.checkpoint import CheckpointDir
    return CheckpointDir(args.out_dir, resume=getattr(args, "resume", False))


def _run_asm(ref, read_seqs, args, reads_by_chrom=None):
    """phase → partition → assemble every chromosome.

    Returns (contigs, phased SNP VcfRecords — the longshot-VCF-equivalent
    output, README.md:237-238).  Per-chromosome results checkpoint to
    <out_dir>/checkpoints/ and are reused under --resume (the reference's
    log.txt skip-list contract, General_Assembly_Workflow.py:530-547).

    Multi-process: each host assembles its owned chromosome shard (reads
    alignment is query-sharded too) and the per-chromosome checkpoint
    artifacts in the shared out_dir ARE the exchange medium — after the
    barrier every host loads all chromosomes' contigs/SNPs, so downstream
    stages see the identical full assembly on every host."""
    from .ops.pack import encode_seq
    from .parallel import multiproc as mp
    from .parallel.mesh import host_chromosome_shard
    from .phasing import snp_vcf_records
    from .pipeline.asm import assemble_chromosome
    cfg = PipelineConfig.for_dtype(args.dtype)
    ckpt = _ckpt(args)
    bed = {}
    if getattr(args, "hybrid_bed", None):
        from .io.bed import read_bed
        bed = read_bed(args.hybrid_bed)
    chroms = [args.chrom] if getattr(args, "chrom", None) else list(ref)
    multi = mp.n_processes() > 1
    own = host_chromosome_shard(chroms) if multi else chroms
    todo = [c for c in own
            if not (ckpt.has(f"asm_{c}.fa") and ckpt.has(f"snps_{c}.vcf"))]
    by_chrom, phased_writer = {}, None
    if todo:
        if reads_by_chrom is not None:
            # caller already aligned the reads (cmd_run aligns once for the
            # whole pipeline) — reuse instead of a second alignment pass
            by_chrom = {c: reads_by_chrom.get(c, []) for c in own}
        else:
            by_chrom = _align_by_chrom_sharded(
                ref, read_seqs, _read_preset(args.dtype), args.out_dir,
                "reads_asm", want=own)
        # phased BAM with HP/PS tags — longshot's '-O phased.bam' artifact
        # (volcanosv-asm.py:75-80; tag semantics prepare_info_v1.py:42-63);
        # per-host part files under multi-process (owned chromosomes only)
        from .io.bam import BamWriter
        os.makedirs(args.out_dir, exist_ok=True)
        suffix = f"_p{mp.process_id()}" if multi else ""
        phased_writer = BamWriter(
            os.path.join(args.out_dir, f"phased{suffix}.bam"),
            list(ref), [len(s) for s in ref.values()])
    results: dict[str, tuple[dict, list]] = {}
    for chrom in own:
        if chrom not in todo:
            log.info("resume: reusing checkpointed assembly for %s", chrom)
            results[chrom] = (ckpt.load_fasta(f"asm_{chrom}.fa"),
                              ckpt.load_vcf(f"snps_{chrom}.vcf"))
            continue
        recs = by_chrom.get(chrom, [])
        if not recs:
            ckpt.save_fasta(f"asm_{chrom}.fa", {})
            ckpt.save_vcf(f"snps_{chrom}.vcf", [])
            results[chrom] = ({}, [])
            continue
        with stage_timer(f"asm[{chrom}]", log):
            ctgs, ph, part = assemble_chromosome(
                recs, encode_seq(ref[chrom]), read_seqs, cfg,
                hybrid_bed=bed.get(chrom))
        if getattr(args, "emit_fastqs", False):
            # per-hap FASTQs (write_fastq_asm_general.py:97-142 parity;
            # double-assigned reads are duplicated into both haps)
            from .io.fastq import write_fastq
            fq_dir = os.path.join(args.out_dir, "fastq_by_hap")
            os.makedirs(fq_dir, exist_ok=True)
            by_hap: dict[str, list] = {}
            for rname, haps in part.assignment.items():
                seq = read_seqs.get(rname)
                if seq:
                    for h in haps:
                        by_hap.setdefault(h, []).append((rname, seq, None))
            for h, entries in by_hap.items():
                write_fastq(os.path.join(fq_dir, f"{h}.fastq"), entries)
        snps = snp_vcf_records(chrom, ph)
        ckpt.save_fasta(f"asm_{chrom}.fa", ctgs)
        ckpt.save_vcf(f"snps_{chrom}.vcf", snps)
        results[chrom] = (ctgs, snps)
        hp_of = {n: (int(ph.read_hap[i]), int(ph.read_block[i]))
                 for i, n in enumerate(ph.read_names)
                 if ph.read_hap[i] != 0}
        # read_hp_og.p-equivalent artifact (prepare_info_v1.py:79-85) —
        # also drives the phase-aware GT downgrade at vc time
        ckpt.save_read_hp(f"read_hp_{chrom}.tsv", hp_of)
        if phased_writer is not None:
            for r in recs:
                hp = hp_of.get(r.name)
                if hp is not None:
                    r.tags = dict(r.tags or {})
                    r.tags["HP"] = hp[0]
                    r.tags["PS"] = hp[1]
                phased_writer.write(r)
    if phased_writer is not None:
        phased_writer.close()
    mp.barrier("asm-exchange")
    contigs: dict[str, str] = {}
    snp_records = []
    read_hp_by_chrom: dict[str, dict[str, int]] = {}
    for chrom in chroms:
        if chrom in results:
            ctgs, snps = results[chrom]
        elif os.path.exists(ckpt.path(f"asm_{chrom}.fa")):
            # another host's shard — read its checkpoint artifacts
            ctgs = ckpt.load_fasta(f"asm_{chrom}.fa")
            snps = ckpt.load_vcf(f"snps_{chrom}.vcf")
        else:
            continue
        if os.path.exists(ckpt.path(f"read_hp_{chrom}.tsv")):
            read_hp_by_chrom[chrom] = ckpt.load_read_hp(
                f"read_hp_{chrom}.tsv")
        snp_records += snps
        for name, seq in ctgs.items():
            while name in contigs:            # cross-chrom PS id collision
                name += "b"
            contigs[name] = seq
    return contigs, snp_records, read_hp_by_chrom


def _align_reads_to_contigs(contigs: dict[str, str],
                            read_seqs: dict[str, str], dtype: str):
    from .aligner import Aligner
    from .config import AlignConfig
    al = Aligner(contigs, AlignConfig.preset(_read_preset(dtype)))
    recs = al.to_bam_records(al.align(list(read_seqs.items())), read_seqs)
    return recs, al.names


def cmd_asm(args) -> int:
    from .io.fasta import write_fasta
    ref = _load_ref(args.ref)
    read_seqs = _load_reads(args)
    if not read_seqs:
        log.error("asm requires --fastq or --bam")
        return 2
    contigs, snp_records, _read_hp = _run_asm(ref, read_seqs, args)
    _vcf_out(args.out_dir, "phased_snps.vcf", ref, snp_records)
    if getattr(args, "sd", False):
        # SD loop needs the read partition; approximate groups from contig
        # hap names by re-aligning reads to contigs (Evaluate_Assembly.py)
        from .pipeline.sd import hap_of_contig, sd_recover
        cfg = PipelineConfig.for_dtype(args.dtype)
        roc, names = _align_reads_to_contigs(contigs, read_seqs, args.dtype)
        groups: dict[str, list[str]] = {}
        for r in roc:
            if r.is_unmapped or r.is_secondary or r.is_supplementary:
                continue
            h = hap_of_contig(names[r.ref_id])
            seq = read_seqs.get(r.name)
            if seq:
                groups.setdefault(h, []).append(seq)
        contigs, _qc = sd_recover(contigs, groups, roc, cfg)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "final_contigs.fa")
    write_fasta(out, contigs)
    log.info("assembly: %d contigs → %s", len(contigs), out)
    return 0


def cmd_qc(args) -> int:
    """Assembly QC report: per-contig window states + collapsed list."""
    from .io.fasta import read_fasta
    from .qc import evaluate_assembly
    contigs = read_fasta(args.contig)
    read_seqs = _load_reads(args)
    if not read_seqs:
        log.error("qc requires --fastq or --bam")
        return 2
    cfg = PipelineConfig.for_dtype(args.dtype)
    roc, names = _align_reads_to_contigs(contigs, read_seqs, args.dtype)
    res = evaluate_assembly(contigs, roc, names, cfg.qc)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "flagger_blocks.bed")
    from .qc.flagger import state_names
    names_q = state_names(cfg.qc.n_states)
    with open(out, "w") as fh:
        for c in res.states:
            for st in range(len(names_q)):
                for s, e in res.blocks(c, st):
                    fh.write(f"{c}\t{s}\t{e}\t{names_q[st]}\n")
    log.info("QC: λ=%.1f, collapsed contigs: %s → %s",
             res.lam, res.collapsed or "none", out)
    return 0


def _reads_sigs_cached(args, ref, cfg, reads_by_chrom, chroms=None):
    """Per-chrom reads signatures with checkpoint reuse (the -rdsig dir
    contract, volcanosv-vc-large-indel.py:18-19).  `chroms` restricts the
    extraction to this process's owned chromosomes so hosts never write
    each other's checkpoint artifacts."""
    if reads_by_chrom is None:
        return None
    from .vc.reads_sig import extract_reads_signatures
    ckpt = _ckpt(args)
    sigs = {}
    for chrom in (chroms if chroms is not None else list(ref)):
        name = f"reads_sig_{chrom}.tsv"
        if ckpt.has(name):
            sigs[chrom] = ckpt.load_sigs(name)
        else:
            sigs[chrom] = extract_reads_signatures(
                reads_by_chrom.get(chrom, []), chrom, cfg.fp_filter)
            ckpt.save_sigs(name, sigs[chrom])
    return sigs


def _own_chroms(ref: dict[str, str]) -> list[str]:
    """This process's chromosome shard.  Single-process → all chromosomes;
    under jax.distributed each host owns a round-robin share (the
    multi-host replacement for '22 SLURM jobs', README.md:244-255)."""
    import jax

    from .parallel.mesh import host_chromosome_shard
    chroms = list(ref)
    if jax.process_count() > 1:
        chroms = host_chromosome_shard(chroms)
        log.info("host %d/%d owns chromosomes: %s", jax.process_index(),
                 jax.process_count(), chroms)
    return chroms


def _pipeline_mesh():
    """The (genome, data) mesh the drivers run collectives over — None when
    only one device is visible (serial fallback path).  Installing it as
    the ACTIVE mesh also routes the aligner's DP window batches through
    the shard_map path (ops.banded_align._sharded_align_walk)."""
    import jax

    from .parallel import make_mesh
    from .parallel.mesh import set_active_mesh
    mesh = make_mesh() if len(jax.devices()) > 1 else None
    if jax.process_count() == 1:
        set_active_mesh(mesh)
    return mesh


def _call_large_indels(ref, by_chrom, contigs, cfg, reads_by_chrom,
                       reads_sigs, chroms=None, include_bed=None,
                       read_hp=None):
    """All-chromosome large-indel calling with the WGS-global coverage
    median computed as a genome-axis collective over the device mesh
    (parallel.wgs.wgs_global_median) — the reference's per-run median after
    the all-chromosome concat (volcanosv-vc-large-indel.py:266-278 +
    filter_vcf_by_sig_cov_insdel.py:38-55)."""
    from .vc.gt_correction import rel_coverage
    from .vc.large_indel import call_chromosome_raw, finalize_chromosome
    chroms = chroms if chroms is not None else list(ref)
    raw: dict[str, tuple] = {}
    for chrom in chroms:
        with stage_timer(f"large-indel[{chrom}]", log):
            raw[chrom] = call_chromosome_raw(
                chrom, by_chrom.get(chrom, []), ref[chrom], contigs, cfg,
                reads_records=(reads_by_chrom or {}).get(chrom),
                reads_sigs=(reads_sigs or {}).get(chrom),
                include_bed=(include_bed or {}).get(chrom))
    medians: dict[str, float] = {}
    have_sigs = [c for c in chroms if raw[c][1] is not None]
    if reads_by_chrom is not None:
        import numpy as _np

        from .parallel.multiproc import gather_across_processes, n_processes
        from .parallel.wgs import wgs_global_median
        # every process MUST take this branch symmetrically (the gather is
        # a collective): reads_by_chrom is None on all hosts or none, and
        # apply_del/apply_ins come from the shared config
        mesh = _pipeline_mesh() if n_processes() == 1 else None
        for svtype, apply_it in (("DEL", cfg.cov_filter.apply_del),
                                 ("INS", cfg.cov_filter.apply_ins)):
            if not apply_it:
                continue
            rels = [rel_coverage(raw[c][0], raw[c][1], cfg.cov_filter,
                                 svtype)[1] for c in have_sigs]
            local = _np.concatenate(rels) if rels else _np.zeros(0, _np.float32)
            with stage_timer("wgs-global-median", log):
                # union of every host's owned-chromosome rel_cov vectors —
                # the per-run global set the reference medians over after
                # its all-chromosome concat
                glob = gather_across_processes(local)
                if len(glob) < cfg.cov_filter.min_calls:
                    continue
                medians[svtype] = wgs_global_median([glob], mesh)
            log.info("WGS-global %s rel_cov median: %.4f over %d calls (%s)",
                     svtype, medians[svtype], len(glob),
                     "mesh collective" if mesh is not None else "host")
    records = []
    for chrom in chroms:
        recs, gt_sigs = raw[chrom]
        records += finalize_chromosome(
            recs, gt_sigs, (reads_by_chrom or {}).get(chrom), cfg,
            cov_medians=medians or None,
            read_hp=(read_hp or {}).get(chrom))
    return records


def _restrict_chroms(args, chroms: list[str]) -> list[str]:
    """Apply --chrom / --bed region restriction (the reference's
    single-chromosome vc mode, volcanosv-vc-large-indel.py:280 +
    filter_GT_correction.py:67-82)."""
    one = getattr(args, "chrom", None)
    if one:
        chroms = [c for c in chroms if c == one]
    bed = getattr(args, "_bed_regions", None)
    if bed:
        chroms = [c for c in chroms if c in bed]
    return chroms


def _load_bed_regions(args):
    if getattr(args, "bed", None):
        from .io.bed import read_bed
        args._bed_regions = read_bed(args.bed)
    else:
        args._bed_regions = None
    return args._bed_regions


def cmd_vc_large_indel(args) -> int:
    from .io.fasta import read_fasta
    from .parallel.mesh import init_multihost
    init_multihost()
    ref = _load_ref(args.ref)
    contigs = read_fasta(args.contig)
    cfg = PipelineConfig.for_dtype(args.dtype, asm=getattr(args, "asm", "volcano"))
    bed = _load_bed_regions(args)
    chroms = _restrict_chroms(args, _own_chroms(ref))
    by_chrom = _align_by_chrom_sharded(ref, contigs, "asm5", args.out_dir,
                                       "contigs_asm5", want=chroms)
    reads_by_chrom, _ = _maybe_reads_by_chrom(args, ref, want=chroms)
    reads_sigs = _reads_sigs_cached(args, ref, cfg, reads_by_chrom,
                                    chroms=chroms)
    records = _call_large_indels(ref, by_chrom, contigs, cfg,
                                 reads_by_chrom, reads_sigs,
                                 chroms=chroms, include_bed=bed)
    _vcf_out_sharded(args.out_dir, "volcanosv_large_indel.vcf", ref, records)
    return 0


def cmd_vc_small_indel(args) -> int:
    """Standalone small-indel driver — multi-process capable: each host
    calls its chromosome shard (query-sharded alignment), rank 0 merges
    (the reference's per-chromosome cluster story, README.md:244-255)."""
    from .io.fasta import read_fasta
    from .parallel.mesh import init_multihost
    from .vc.small_indel import call_small_indels
    init_multihost()
    ref = _load_ref(args.ref)
    contigs = read_fasta(args.contig)
    cfg = PipelineConfig.for_dtype(args.dtype)
    _load_bed_regions(args)
    chroms = _restrict_chroms(args, _own_chroms(ref))
    by_chrom = _align_by_chrom_sharded(ref, contigs, "asm20", args.out_dir,
                                       "contigs_asm20", want=chroms)
    reads_by_chrom, _ = _maybe_reads_by_chrom(args, ref, want=chroms)
    records = []
    for chrom in chroms:
        with stage_timer(f"small-indel[{chrom}]", log):
            records += call_small_indels(
                chrom, by_chrom.get(chrom, []), ref[chrom], cfg,
                reads_records=(reads_by_chrom or {}).get(chrom))
    _vcf_out_sharded(args.out_dir, "volcanosv_small_indel.vcf", ref, records)
    return 0


def _harvest_ins_records(args, ref, contigs, cfg, chroms):
    """INS calls driving DUP recovery (volcanosv-vc-complex-sv.py:131-138).

    The reference's complex driver consumes the LARGE-INDEL VCF
    (align_ins2ref.py input); --large_vcf reuses one instead of re-running
    the whole large-indel caller per chromosome (round-3 weak #6)."""
    from .io.vcf import read_vcf
    from .vc.large_indel import call_chromosome
    if getattr(args, "large_vcf", None):
        _h, recs = read_vcf(args.large_vcf)
        return [r for r in recs if r.svtype == "INS" and r.chrom in chroms]
    by_chrom = _align_by_chrom_sharded(ref, contigs, "asm5", args.out_dir,
                                       "contigs_asm5", want=chroms)
    out = []
    for chrom in chroms:
        out += [r for r in call_chromosome(
            chrom, by_chrom.get(chrom, []), ref[chrom], contigs, cfg)
            if r.svtype == "INS"]
    return out


def cmd_vc_complex_sv(args) -> int:
    """Standalone complex-SV driver — multi-process capable: alignment and
    the INS harvest run on each host's shard; the (global, cross-chrom)
    pairing stage runs identically on every host from the exchanged
    record/alignment sets and rank 0 writes the VCF."""
    from .io.fasta import read_fasta
    from .parallel import multiproc as mp
    from .parallel.mesh import init_multihost
    from .vc.complex_sv import call_complex_svs
    init_multihost()
    ref = _load_ref(args.ref)
    contigs = read_fasta(args.contig)
    cfg = PipelineConfig.for_dtype(args.dtype)
    _load_bed_regions(args)
    chroms = _restrict_chroms(args, list(ref))
    own = [c for c in _own_chroms(ref) if c in chroms]
    # complex pairing is WGS-global (cross-chrom BND mates): every host
    # needs all chromosomes' contig alignments
    by_chrom = _align_by_chrom_sharded(ref, contigs, "asm10", args.out_dir,
                                       "contigs_asm10", want=chroms)
    reads_by_chrom, _ = _maybe_reads_by_chrom(args, ref, want=chroms)
    ins_own = _harvest_ins_records(args, ref, contigs, cfg, own)
    ins_by_chrom: dict[str, list] = {c: [] for c in ref}
    for r in ins_own:
        ins_by_chrom[r.chrom].append(r)
    ins_by_chrom = mp.exchange_by_chrom(ins_by_chrom, args.out_dir,
                                        "cx_ins_recs", want=list(ref))
    ins_records = [r for c in ref for r in ins_by_chrom.get(c, [])]
    ins_records.sort(key=lambda r: (r.chrom, r.pos, r.id))
    if len(chroms) != len(ref):
        by_chrom = {c: by_chrom.get(c, []) for c in chroms}
    with stage_timer("complex-sv", log):
        records = call_complex_svs(by_chrom, ref, cfg,
                                   ins_records=ins_records,
                                   reads_by_chrom=reads_by_chrom)
    if mp.is_rank0():
        _vcf_out(args.out_dir, "volcanosv_complex_sv.vcf", ref, records)
    mp.barrier("cx-final")
    return 0


def cmd_eval(args) -> int:
    """Truvari-equivalent benchmark (README.md:493-498 protocol)."""
    import json
    from .eval import EvalParams, evaluate_files
    res = evaluate_files(args.base, args.comp, EvalParams(
        refdist=args.refdist, pctsize=args.pctsize, pctsim=args.pctsim,
        pctovl=args.pctovl, minsize=args.minsize))
    print(json.dumps(res.summary()))
    return 0


def cmd_merge_vcf(args) -> int:
    from .io.vcf import merge_vcfs
    n = merge_vcfs(args.vcfs, args.out_vcf)
    log.info("merged %d records → %s", n, args.out_vcf)
    return 0


def cmd_run(args) -> int:
    """Full pipeline: asm + all three vc paths + merge (one command).

    Multi-process (jax.distributed): assembly and the per-chromosome vc
    stages run on each host's chromosome shard with query-sharded
    alignment; finalized large-indel records are exchanged so the
    (WGS-only, svim-asm-style) complex-SV stage sees the global INS set on
    every host; rank 0 writes the complex VCF and the final merge."""
    from .io.fasta import write_fasta
    from .io.vcf import merge_vcfs
    from .parallel import multiproc as mp
    from .parallel.mesh import init_multihost
    from .vc.complex_sv import call_complex_svs
    from .vc.small_indel import call_small_indels
    init_multihost()
    ref = _load_ref(args.ref)
    read_seqs = _load_reads(args)
    if not read_seqs:
        log.error("run requires --fastq or --bam")
        return 2
    cfg = PipelineConfig.for_dtype(args.dtype)
    os.makedirs(args.out_dir, exist_ok=True)
    multi = mp.n_processes() > 1
    own = _own_chroms(ref)

    # ONE read-alignment pass serves assembly AND every vc stage (the
    # complex-SV WGS stage needs all chromosomes, so exchange want=all)
    reads_by_chrom = _align_by_chrom_sharded(
        ref, read_seqs, _read_preset(args.dtype), args.out_dir, "reads_run")
    contigs, snp_records, read_hp_by_chrom = _run_asm(
        ref, read_seqs, args, reads_by_chrom=reads_by_chrom)
    if mp.is_rank0():
        write_fasta(os.path.join(args.out_dir, "final_contigs.fa"), contigs)
        _vcf_out(args.out_dir, "phased_snps.vcf", ref, snp_records)
    log.info("assembly: %d contigs", len(contigs))
    li_by_chrom = _align_by_chrom_sharded(ref, contigs, "asm5",
                                          args.out_dir, "ctg_asm5")
    reads_sigs = _reads_sigs_cached(args, ref, cfg, reads_by_chrom,
                                    chroms=own)
    large_own = _call_large_indels(ref, li_by_chrom, contigs, cfg,
                                   reads_by_chrom, reads_sigs, chroms=own,
                                   read_hp=read_hp_by_chrom)
    # global finalized record set on every host (drives DUP recovery and
    # the consumed-INS dedup identically everywhere)
    large_by_chrom: dict[str, list] = {c: [] for c in ref}
    for r in large_own:
        large_by_chrom[r.chrom].append(r)
    large_by_chrom = mp.exchange_by_chrom(large_by_chrom, args.out_dir,
                                          "large_recs", want=list(ref))
    large = [r for c in ref for r in large_by_chrom.get(c, [])]
    # normalize record order so single- and multi-process paths drive the
    # DUP recovery / complex stage identically (emission order is not
    # preserved across the exchange)
    _rank = {c: i for i, c in enumerate(ref)}
    large.sort(key=lambda r: (_rank[r.chrom], r.pos, r.id))
    ins_records = [r for r in large if r.svtype == "INS"]

    si_by_chrom = _align_by_chrom_sharded(ref, contigs, "asm20",
                                          args.out_dir, "ctg_asm20",
                                          want=own)
    small = []
    for chrom in own:
        small += call_small_indels(chrom, si_by_chrom.get(chrom, []),
                                   ref[chrom], cfg,
                                   reads_records=reads_by_chrom.get(chrom),
                                   read_hp=read_hp_by_chrom.get(chrom))
    p_small = _vcf_out_sharded(args.out_dir, "volcanosv_small_indel.vcf",
                               ref, small)

    cx_by_chrom = _align_by_chrom_sharded(ref, contigs, "asm10",
                                          args.out_dir, "ctg_asm10",
                                          want=(None if mp.is_rank0()
                                                else []))
    consumed: set = set()
    # the WGS-global complex stage (cross-chrom BND pairing + DUP-recovery
    # realignment) runs ONCE on rank 0; (records, consumed INS ids) are
    # broadcast so every host filters its large-indel share identically
    if mp.is_rank0():
        complex_recs = call_complex_svs(cx_by_chrom, ref, cfg,
                                        ins_records=ins_records,
                                        reads_by_chrom=reads_by_chrom,
                                        consumed_ins=consumed)
    else:
        complex_recs = None
    complex_recs, consumed = mp.broadcast_from_rank0(
        (complex_recs, consumed) if mp.is_rank0() else None,
        args.out_dir, "complex")
    p_cx = os.path.join(args.out_dir, "volcanosv_complex_sv.vcf")
    if mp.is_rank0():
        _vcf_out(args.out_dir, "volcanosv_complex_sv.vcf", ref, complex_recs)
    if consumed:
        # an INS the DUP recovery reclassified is reported once, as <DUP>
        # (align_ins2ref.py role)
        large = [r for r in large if r.id not in consumed]
    # each host writes its owned chromosomes' share of the global set
    large_mine = [r for r in large if not multi or r.chrom in own]
    p_large = _vcf_out_sharded(args.out_dir, "volcanosv_large_indel.vcf",
                               ref, large_mine)

    out = os.path.join(args.out_dir, "volcanosv_variants.vcf")
    if mp.is_rank0():
        n = merge_vcfs([p_large, p_small, p_cx], out)
        log.info("FINAL: %d variants → %s", n, out)
    mp.barrier("run-final")
    return 0


# ---------------------------------------------------------------------------

def _add_common(p, contig=False, reads=True):
    p.add_argument("--ref", required=True, help="reference FASTA")
    p.add_argument("--out_dir", "-o", required=True)
    p.add_argument("--dtype", "-d", default="Hifi",
                   choices=["Hifi", "CLR", "ONT"])
    if contig:
        p.add_argument("--contig", required=True,
                       help="hp1/hp2-named contig FASTA (otherasm contract)")
        p.add_argument("--asm", default="volcano",
                       choices=["volcano", "other"],
                       help="coverage-band profile row (filter_para.csv "
                            "asm column; 'other' for imported assemblies)")
        p.add_argument("--chrom",
                       help="restrict calling to one chromosome "
                            "(single-chrom mode, "
                            "volcanosv-vc-large-indel.py:280)")
        p.add_argument("--bed",
                       help="BED restricting calling + the GT-signature "
                            "task grid (sig_extract -include_bed, "
                            "filter_GT_correction.py:67-82)")
    if reads:
        p.add_argument("--fastq", help="reads FASTQ(.gz)")
        p.add_argument("--bam", help="reads BAM")
    p.add_argument("--resume", action="store_true",
                   help="reuse per-stage artifacts from "
                        "<out_dir>/checkpoints/ (skip-list resume)")
    p.add_argument("--profile", action="store_true",
                   help="write <out_dir>/stage_times.json + print the "
                        "per-stage wall-clock table")
    p.add_argument("--profile_trace", metavar="DIR",
                   help="capture a JAX profiler trace (TensorBoard/Perfetto) "
                        "of the whole command into DIR")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="volcanosv_tpu",
        description="GPU-accelerated diploid SV engine (VolcanoSV capabilities)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sim", help="synthesize test data")
    p.add_argument("--out_dir", "-o", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--length", type=int, default=80_000)
    p.add_argument("--chroms", type=int, default=1)
    p.add_argument("--n_del", type=int, default=4)
    p.add_argument("--n_ins", type=int, default=4)
    p.add_argument("--n_inv", type=int, default=0)
    p.add_argument("--n_dup", type=int, default=0)
    p.add_argument("--n_tra", type=int, default=0,
                   help="implant a reciprocal cross-chromosome "
                        "translocation (needs --chroms >= 2)")
    p.add_argument("--n_clustered", type=int, default=0,
                   help="clustered DEL+INS pairs 600-900bp apart, per chrom")
    p.add_argument("--n_nested", type=int, default=0,
                   help="INVs with an interior deletion (nested), per chrom")
    p.add_argument("--n_small", type=int, default=0,
                   help="2-49bp indels (small-indel path truth), per chrom")
    p.add_argument("--n_tandem", type=int, default=0,
                   help="tandem repeat arrays in the REFERENCE, per chrom")
    p.add_argument("--n_segdup", type=int, default=0,
                   help="dispersed ~97%%-identity segdup pairs, per chrom")
    p.add_argument("--n_homopoly", type=int, default=0,
                   help="15-40bp homopolymer runs, per chrom")
    p.add_argument("--min_len", type=int, default=60)
    p.add_argument("--max_len", type=int, default=400)
    p.add_argument("--snp_rate", type=float, default=1 / 1500)
    p.add_argument("--coverage", type=float, default=24.0)
    p.add_argument("--read_len", type=int, default=8_000)
    p.add_argument("--err", type=float, default=0.001)
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("asm", help="phase + partition + assemble")
    _add_common(p)
    p.add_argument("--chrom", help="restrict to one chromosome")
    p.add_argument("--sd", action="store_true",
                   help="QC + re-assemble collapsed blocks (SD recovery)")
    p.add_argument("--hybrid_bed",
                   help="BED of regions assembled with the in-BED profile "
                        "(hybrid mode, volcanosv-asm_hybrid.py parity)")
    p.add_argument("--emit_fastqs", action="store_true",
                   help="also write fastq_by_hap/<hap>.fastq per haplotype "
                        "(write_fastq_asm_general.py parity)")
    p.set_defaults(fn=cmd_asm)

    p = sub.add_parser("qc", help="coverage-HMM assembly QC (Flagger equiv)")
    _add_common(p, contig=True)
    p.set_defaults(fn=cmd_qc)

    p = sub.add_parser("vc-large-indel", help="large-indel calling (≥30bp)")
    _add_common(p, contig=True)
    p.set_defaults(fn=cmd_vc_large_indel)

    p = sub.add_parser("vc-small-indel", help="small-indel calling (2-49bp)")
    _add_common(p, contig=True)
    p.set_defaults(fn=cmd_vc_small_indel)

    p = sub.add_parser("vc-complex-sv", help="INV/DUP/TRA calling")
    _add_common(p, contig=True)
    p.add_argument("--large_vcf",
                   help="large-indel VCF whose INS records drive DUP "
                        "recovery (align_ins2ref.py input contract); "
                        "without it the large-indel caller runs inline")
    p.set_defaults(fn=cmd_vc_complex_sv)

    p = sub.add_parser("eval", help="truvari-equivalent SV benchmark")
    p.add_argument("--base", required=True, help="truth VCF")
    p.add_argument("--comp", required=True, help="call VCF")
    p.add_argument("-r", "--refdist", type=int, default=500)
    p.add_argument("-P", "--pctsize", type=float, default=0.5)
    p.add_argument("-p", "--pctsim", type=float, default=0.5)
    p.add_argument("-O", "--pctovl", type=float, default=0.01)
    p.add_argument("-S", "--minsize", type=int, default=30)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("merge-vcf", help="merge VCFs (Merge_VCF.py)")
    p.add_argument("vcfs", nargs="+")
    p.add_argument("--out_vcf", required=True)
    p.set_defaults(fn=cmd_merge_vcf)

    p = sub.add_parser("run", help="full pipeline reads → merged VCF")
    _add_common(p)
    p.set_defaults(fn=cmd_run)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    trace_dir = getattr(args, "profile_trace", None)
    if trace_dir:
        import jax
        with jax.profiler.trace(trace_dir):
            rc = args.fn(args)
    else:
        rc = args.fn(args)
    if getattr(args, "profile", False) and getattr(args, "out_dir", None):
        import json
        from .utils.logging import STAGE_TIMES, stage_report
        path = os.path.join(args.out_dir, "stage_times.json")
        os.makedirs(args.out_dir, exist_ok=True)
        with open(path, "w") as fh:
            json.dump({k: {"total_s": round(v[0], 4), "calls": v[1]}
                       for k, v in STAGE_TIMES.items()}, fh, indent=1)
        log.info("profile:\n%s\n→ %s", stage_report(), path)
    return rc


if __name__ == "__main__":
    sys.exit(main())
