"""Large-indel path WITH the read-evidence stages (FP filter, coverage
band-pass, GT correction) — reads simulated with sequencing error and
aligned by the native aligner (map preset)."""
import numpy as np
import pytest

from volcanosv_tpu.aligner import Aligner
from volcanosv_tpu.config import AlignConfig, PipelineConfig
from volcanosv_tpu.sim import (contigs_from_haplotypes, implant_svs,
                               random_genome, simulate_reads)
from volcanosv_tpu.vc.large_indel import call_chromosome
from test_large_indel import truvari_score


@pytest.fixture(scope="module")
def full_case():
    rng = np.random.default_rng(11)
    ref = random_genome(rng, 150_000)
    hap1, hap2, truth = implant_svs(
        rng, ref, n_del=4, n_ins=4, min_len=50, max_len=300, min_gap=4_000)
    contigs = contigs_from_haplotypes(hap1, hap2, block_size=80_000,
                                      overlap=8_000)
    reads = simulate_reads(
        rng, {1: hap1, 2: hap2}, coverage=12.0, read_len=8_000,
        read_len_sd=1_000, sub_rate=0.001, indel_rate=0.0005)
    return ref, contigs, truth, reads


def test_full_path_with_read_evidence(full_case):
    ref, contigs, truth, reads = full_case
    aligner = Aligner(ref, AlignConfig.preset("asm5"))
    contig_recs = aligner.to_bam_records(
        aligner.align(list(contigs.items())), contigs)
    read_aligner = Aligner(ref, AlignConfig.preset("map-hifi"))
    read_seqs = {name: seq for name, seq, *_ in reads}
    read_recs = read_aligner.to_bam_records(
        read_aligner.align([(n, s) for n, s in read_seqs.items()]), read_seqs)

    cfg = PipelineConfig.for_dtype("Hifi")
    records = call_chromosome("chr1", contig_recs, ref["chr1"], contigs, cfg,
                              reads_records=read_recs)
    recall, precision, gt_frac = truvari_score(truth, records)
    assert recall >= 0.85, (recall, precision, len(records), len(truth))
    assert precision >= 0.85, (recall, precision, len(records))
    # SUPPORT annotated by GT correction
    assert any("SUPPORT" in r.info for r in records)


def test_mesh_and_serial_paths_byte_identical(full_case, tmp_path, monkeypatch):
    """cmd-level WGS large-indel driver: the genome-axis mesh collective
    median (8-device CPU mesh) and the serial host path emit byte-identical
    VCFs (VERDICT round-1 item 1 'done' criterion)."""
    import dataclasses
    import os

    import volcanosv_tpu.cli as cli

    ref, contigs, truth, reads = full_case
    aligner = Aligner(ref, AlignConfig.preset("asm5"))
    contig_recs = aligner.to_bam_records(
        aligner.align(list(contigs.items())), contigs)
    read_aligner = Aligner(ref, AlignConfig.preset("map-hifi"))
    read_seqs = {name: seq for name, seq, *_ in reads}
    read_recs = read_aligner.to_bam_records(
        read_aligner.align([(n, s) for n, s in read_seqs.items()]), read_seqs)

    cfg = PipelineConfig.for_dtype("Hifi")
    # tiny sim → force the band-pass to engage so the median matters
    cfg = dataclasses.replace(
        cfg, cov_filter=dataclasses.replace(cfg.cov_filter, min_calls=1))
    by_chrom = {"chr1": contig_recs}
    reads_by_chrom = {"chr1": read_recs}

    import jax
    assert len(jax.devices()) > 1          # conftest forces 8 CPU devices
    mesh_records = cli._call_large_indels(
        ref, by_chrom, contigs, cfg, reads_by_chrom, None)

    monkeypatch.setattr(cli, "_pipeline_mesh", lambda: None)
    serial_records = cli._call_large_indels(
        ref, by_chrom, contigs, cfg, reads_by_chrom, None)

    from volcanosv_tpu.io.vcf import make_header, write_vcf
    pa, pb = str(tmp_path / "mesh.vcf"), str(tmp_path / "serial.vcf")
    hdr = make_header({c: len(s) for c, s in ref.items()})
    write_vcf(pa, hdr, mesh_records)
    write_vcf(pb, hdr, serial_records)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    assert mesh_records, "no records — test degenerated"
