"""The crown-jewel integration test: reads → phasing → k-mer partition →
local assembly → contig alignment → large-indel calls, scored against
implanted truth.  This is the whole volcanosv-asm + volcanosv-vc path on
simulated HiFi data (reference contract: chr10 golden test, SURVEY.md §4)."""
import numpy as np
import pytest

from volcanosv_tpu.aligner import Aligner
from volcanosv_tpu.config import AlignConfig, PipelineConfig
from volcanosv_tpu.ops.pack import encode_seq
from volcanosv_tpu.pipeline import assemble_chromosome
from volcanosv_tpu.sim import (implant_snps, implant_svs, random_genome,
                               simulate_reads)
from volcanosv_tpu.vc.large_indel import call_chromosome
from test_large_indel import truvari_score


@pytest.fixture(scope="module")
def pipeline_case():
    rng = np.random.default_rng(21)
    ref = random_genome(rng, 80_000)
    hap1, hap2, truth = implant_svs(
        rng, ref, n_del=3, n_ins=3, min_len=60, max_len=250, min_gap=4_000)
    hap1, hap2, _ = implant_snps(rng, hap1, hap2, rate=1 / 1200)
    reads = simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=24.0, read_len=7_000,
        read_len_sd=900, sub_rate=0.001, indel_rate=0.0005)
    return ref, truth, reads


def test_pipeline_end_to_end(pipeline_case):
    ref, truth, reads = pipeline_case
    cfg = PipelineConfig.for_dtype("Hifi")

    # align reads (the volcanosv-asm input BAM)
    read_seqs = {n: s for n, s, *_ in reads}
    read_aligner = Aligner(ref, AlignConfig.preset("map-hifi"))
    read_recs = read_aligner.to_bam_records(
        read_aligner.align(list(read_seqs.items())), read_seqs)

    # asm: phase → partition → assemble
    contigs, ph, part = assemble_chromosome(
        read_recs, encode_seq(ref["chr1"]), read_seqs, cfg)
    assert contigs, "assembly produced no contigs"
    total_bp = sum(len(s) for s in contigs.values())
    assert total_bp >= 1.2 * len(ref["chr1"]), total_bp  # ~2 haplotypes

    # vc: align contigs, call large indels
    contig_aligner = Aligner(ref, AlignConfig.preset("asm5"))
    contig_recs = contig_aligner.to_bam_records(
        contig_aligner.align(list(contigs.items())), contigs)
    records = call_chromosome("chr1", contig_recs, ref["chr1"], contigs, cfg,
                              reads_records=read_recs)
    recall, precision, gt_frac = truvari_score(truth, records)
    assert recall >= 0.8, (recall, precision, len(records), len(truth))
    assert precision >= 0.7, (recall, precision, len(records))


def test_hybrid_bed_mode(pipeline_case):
    """In-BED blocks take the duplicate-aware profile; output still covers
    the genome (volcanosv-asm_hybrid.py parity)."""
    from volcanosv_tpu.pipeline import assemble_chromosome as asm
    ref, truth, reads = pipeline_case
    cfg = PipelineConfig.for_dtype("Hifi")
    read_seqs = {n: s for n, s, *_ in reads}
    al = Aligner(ref, AlignConfig.preset("map-hifi"))
    recs = al.to_bam_records(al.align(list(read_seqs.items())), read_seqs)
    contigs, _ph, _part = asm(
        recs, encode_seq(ref["chr1"]), read_seqs, cfg,
        hybrid_bed=[(0, 40_000)])
    total = sum(len(s) for s in contigs.values())
    assert total >= 1.2 * len(ref["chr1"]), total
