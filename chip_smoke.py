"""Smoke run of the whole system on NVIDIA GPUs.

    python chip_smoke.py                # phases (a)-(d) on one card
    python chip_smoke.py --four_cards   # only the 4-card mesh path

One card, in one process:
  (a) preflight: JAX must see a GPU; prints the card's name and power limit
      (nvidia-smi), builds the native host library and the CUDA kernels.
  (b) kernel: the platform's banded-DP kernel (ops.banded_align.dp_kernel)
      against plain banded_align_scan on the same card at the pipeline's
      shapes, single- and dual-affine: scores, end columns, diagonal-0
      profiles, traceback rows and walked op streams must be identical;
      sampled scores must equal the full-matrix DP.  Prints ms per batch,
      GCUPS (B x M x W cells per second) and the compiled memory of both,
      and the end-to-end time of Aligner.align with each.
  (c) golden: `sim` with the golden test's arguments, `run`, and the golden
      test's accuracy gates (tests/test_golden_e2e.py).
  (d) scale: tools/scale_run.py's HiFi run at SCALE_MB (5) Mb x 24x;
      large-SV F1 must reach 0.97.

--four_cards runs the golden input through `run` on a 4-card (genome, data)
mesh and on one card in the same process, compares the two merged VCFs
record for record, scores both, and compares the sharded DP's CIGARs with
the single-device kernel's on one batch.

Any failed check raises, so the script exits non-zero; the last line of a
passing run is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# (name, W, d_lo, M, B, mode): the pipeline's DP shapes.  Refine batches
# are aligner._RefinePipeline._bucket_flush_at's caps; polish is
# olc._batched_cigars at its traceback cap; edit distance is redundancy's
# clipped band.
SHAPES = [
    ("refine", 256, -128, 256, 4096, "cigar"),
    ("refine", 256, -128, 2048, 1024, "cigar"),
    ("refine", 256, -128, 8192, 256, "cigar"),
    ("split", 128, -64, 2048, 1024, "row0"),
    ("polish", 64, -32, 1024, 4096, "cigar"),
    ("edit", 128, -64, 1024, 8192, "edit"),
]
DUAL_SHAPES = [s for s in SHAPES if s[0] == "refine"]
N_ORACLE_ROWS = 32
E2E_REF_BP = 800_000          # Aligner.align workload: 20x of 8 kb reads
SCALE_MB = 5.0


def _log(msg: str) -> None:
    print(msg, flush=True)


def _scores(preset: str):
    from volcanosv_tpu.config import AlignConfig
    from volcanosv_tpu.ops.banded_align import Scores
    c = AlignConfig.preset(preset)
    return Scores(match=c.match, mismatch=c.mismatch, gap_open=c.gap_open,
                  gap_extend=c.gap_extend, gap_open2=c.gap_open2,
                  gap_extend2=c.gap_extend2)


def _pairs(rng, B: int, M: int, N: int):
    """Query rows of random length in [M/2, M]; targets are the query with
    0.5% substitutions and one indel of up to 20 bases, except every tenth
    row, which is unrelated.  Returns (q, t, qlen, tlen, related)."""
    q = rng.integers(0, 4, (B, M), dtype=np.int8)
    qlen = rng.integers(M // 2, M + 1, B).astype(np.int32)
    shift = rng.integers(-20, 21, B)
    pos = (rng.random(B) * qlen).astype(np.int64)
    j = np.arange(N)[None, :]
    src = np.where(j < pos[:, None], j, j - shift[:, None])
    ins = (shift[:, None] > 0) & (j >= pos[:, None]) & (j < pos[:, None]
                                                         + shift[:, None])
    t = np.take_along_axis(q, np.clip(src, 0, M - 1), axis=1)
    noise = rng.integers(0, 4, (B, N), dtype=np.int8)
    sub = rng.random((B, N)) < 0.005
    t = np.where(ins | sub, noise, t)
    tlen = np.clip(qlen + shift, 1, N).astype(np.int32)
    related = np.arange(B) % 10 != 3
    t[~related] = noise[~related]
    t = np.where(j < tlen[:, None], t, 4).astype(np.int8)
    return q, t, qlen, tlen, related


def _best_time(fn, reps: int) -> float:
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def phase_preflight() -> dict:
    from volcanosv_tpu.native import get_lib
    from volcanosv_tpu.ops.banded_align import dp_kernel
    from volcanosv_tpu.utils.device import gpu_name_power, require_gpu

    device = require_gpu()
    _log(f"[a] device: {device['kind']} x{device['count']}")
    _log("[a] nvidia-smi --query-gpu=name,power.limit:")
    _log(gpu_name_power())
    if get_lib() is None:
        raise RuntimeError("native host library did not build (see log)")
    t0 = time.perf_counter()
    kern = dp_kernel()
    _log(f"[a] banded-DP kernel: {kern.name} (ready in "
         f"{time.perf_counter() - t0:.1f} s)")
    return device


def _check_case(kern, name, W, d_lo, M, B, mode, scores, rng, reps):
    """One shape: identity against the scan on the card, then timings."""
    import jax
    import jax.numpy as jnp

    from volcanosv_tpu.ops.banded_align import (SCAN, Scores, _align_walk,
                                                _walk_steps)
    if mode == "edit":
        scores = Scores.edit()
    q, t, qlen, tlen, related = _pairs(rng, B, M, M + W)
    qd, td = jnp.asarray(q), jnp.asarray(t)
    qld, tld = jnp.asarray(qlen), jnp.asarray(tlen)
    kw = dict(W=W, d_lo=d_lo, scores=scores, with_traceback=mode == "cigar",
              row0_scores=mode == "row0")
    got = kern.align(qd, td, qld, tld, **kw)
    want = SCAN.align(qd, td, qld, tld, **kw)
    for label, a, b in zip(("score", "tb", "end_j", "row0"), got, want):
        if a is None:
            continue
        if label == "tb":      # rows at or past qlen are never read
            rows = jnp.arange(M)[:, None, None] < qld[None, :, None]
            same = bool(jnp.all(jnp.where(rows, a == b, True)))
        else:
            same = bool(jnp.array_equal(a, b))
        if not same:
            raise AssertionError(f"{name} M={M}: {label} differs from scan")
    if mode == "cigar":
        n_steps, _full = _walk_steps(M, W, qlen, tlen)
        walk_k = kern.walk(got[1], qld, tld, d_lo, n_steps)
        walk_s = SCAN.walk(want[1], qld, tld, d_lo, n_steps)
        if not bool(jnp.array_equal(walk_k, walk_s)):
            raise AssertionError(f"{name} M={M}: op streams differ")
    del got, want

    cells = B * M * W
    out = {"shape": f"{name} W={W} d_lo={d_lo} M={M} B={B}",
           "scores": "dual" if scores.dual else
           ("edit" if mode == "edit" else "single")}
    for label, k in (("kernel", kern), ("scan", SCAN)):
        fn = jax.jit(lambda a, b, c, d, k=k: k.align(a, b, c, d, **kw))
        out[f"{label}_ms"] = 1e3 * _best_time(
            lambda: fn(qd, td, qld, tld), reps)
        out[f"{label}_gcups"] = cells / out[f"{label}_ms"] / 1e6
        if mode == "cigar":
            aw = dict(kern=k, W=W, d_lo=d_lo, scores=scores, n_steps=n_steps)
            out[f"{label}_dp_walk_ms"] = 1e3 * _best_time(
                lambda: _align_walk(qd, td, qld, tld, **aw), reps)
            mem = _align_walk.lower(qd, td, qld, tld, **aw).compile() \
                .memory_analysis()
            for f in ("argument", "output", "temp"):
                out[f"{label}_{f}_bytes"] = getattr(
                    mem, f"{f}_size_in_bytes", None)
    _log(f"[b] {json.dumps(out)}")
    return out, (q, t, qlen, tlen, related)


def _oracle_rows(kern, data, W, d_lo, scores, rng) -> None:
    """Kernel scores of sampled related rows == the full-matrix DP."""
    from volcanosv_tpu.ops.banded_align import full_affine_score_np
    q, t, qlen, tlen, related = data
    rows = rng.choice(np.nonzero(related)[0], N_ORACLE_ROWS, replace=False)
    s = np.asarray(kern.align(q[rows], t[rows], qlen[rows], tlen[rows], W=W,
                              d_lo=d_lo, scores=scores,
                              with_traceback=False)[0])
    for i, b in enumerate(rows):
        ref = full_affine_score_np(q[b, :qlen[b]], t[b, :tlen[b]], scores)
        if int(s[i]) != ref:
            raise AssertionError(f"row {b}: kernel {s[i]} != full DP {ref}")


def _aligner_time(read_seqs, ref, preset: str):
    from volcanosv_tpu.aligner import Aligner
    from volcanosv_tpu.config import AlignConfig
    aligner = Aligner(ref, AlignConfig.preset(preset))
    alns = aligner.align(read_seqs)                     # compiles
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        alns = aligner.align(read_seqs)
        best = min(best, time.perf_counter() - t0)
    return best, alns


def phase_kernel() -> list:
    import jax

    from volcanosv_tpu.ops import banded_align as ba
    from volcanosv_tpu.sim import random_genome, simulate_reads

    kern = ba.dp_kernel()
    rng = np.random.default_rng(7)
    results = []
    for preset, shapes in (("map-hifi", SHAPES), ("asm20", DUAL_SHAPES)):
        scores = _scores(preset)
        for name, W, d_lo, M, B, mode in shapes:
            res, data = _check_case(kern, name, W, d_lo, M, B, mode, scores,
                                    rng, reps=3)
            results.append(res)
            if (name, M) == ("refine", 256):
                _oracle_rows(kern, data, W, d_lo, scores, rng)
    # free_t_end (fitting alignment) once, against the scan
    q, t, qlen, tlen, _ = _pairs(rng, 512, 512, 768)
    kw = dict(W=256, d_lo=-128, scores=_scores("map-hifi"),
              with_traceback=False, free_t_end=True)
    a, b = kern.align(q, t, qlen, tlen, **kw), ba.SCAN.align(q, t, qlen,
                                                             tlen, **kw)
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])):
        raise AssertionError("free_t_end differs from scan")
    _log(f"[b] identical to scan at {len(results)} shapes; "
         f"{2 * N_ORACLE_ROWS} rows equal the full DP")

    # end to end: Aligner.align (map-hifi reads) with each kernel
    grng = np.random.default_rng(1)
    ref = random_genome(grng, E2E_REF_BP)
    reads = simulate_reads(grng, {1: ref}, coverage=20.0, read_len=8_000,
                           sub_rate=0.002, indel_rate=0.001)
    read_seqs = [(n, s) for n, s, *_ in reads]
    t_k, alns_k = _aligner_time(read_seqs, ref, "map-hifi")
    real = ba.dp_kernel
    ba.dp_kernel = lambda platform=None: ba.SCAN
    try:
        t_s, alns_s = _aligner_time(read_seqs, ref, "map-hifi")
    finally:
        ba.dp_kernel = real
    same = [(a.qname, a.pos, a.cigar) for a in alns_k] == \
        [(a.qname, a.pos, a.cigar) for a in alns_s]
    if not same:
        raise AssertionError("Aligner.align: kernel and scan alignments differ")
    e2e = {"aligner_reads": len(read_seqs), "kernel_s": t_k, "scan_s": t_s}
    _log(f"[b] Aligner.align map-hifi end to end: {json.dumps(e2e)}")
    results.append(e2e)
    _log(f"[b] peak device bytes: {_peak(jax.devices()[0])}")
    return results


def _repo_module(relpath: str):
    """Load a module of this checkout by path (a package named like it,
    e.g. an installed `tests`, must not shadow it)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)
    name = os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _peak(dev) -> int:
    return dev.memory_stats()["peak_bytes_in_use"]


def _sim_and_run(work: str, tag: str) -> tuple[str, str, float]:
    from volcanosv_tpu.cli import main as cli_main
    SIM_ARGS = _repo_module("tests/test_golden_e2e.py").SIM_ARGS
    sim_dir = os.path.join(work, "sim")
    out_dir = os.path.join(work, f"out_{tag}")
    if not os.path.exists(os.path.join(sim_dir, "reads.fastq")):
        if cli_main(["sim", "-o", sim_dir] + SIM_ARGS) != 0:
            raise RuntimeError("sim failed")
    t0 = time.perf_counter()
    if cli_main(["run", "--ref", f"{sim_dir}/ref.fa", "--fastq",
                 f"{sim_dir}/reads.fastq", "-o", out_dir]) != 0:
        raise RuntimeError(f"run ({tag}) failed")
    return sim_dir, out_dir, time.perf_counter() - t0


def phase_golden(work: str) -> dict:
    from volcanosv_tpu.eval import evaluate_files
    golden = _repo_module("tests/test_golden_e2e.py")

    sim_dir, out_dir, wall = _sim_and_run(work, "golden")
    run = (sim_dir, out_dir)
    for check in (golden.test_truth_vcf_pinned, golden.test_truth_scale,
                  golden.test_golden_f1_and_gt, golden.test_golden_small_indel,
                  golden.test_golden_snps_and_switch_error,
                  golden.test_golden_cross_chrom_bnd):
        check(run)
    res = evaluate_files(os.path.join(sim_dir, "truth.vcf"),
                         os.path.join(out_dir, "volcanosv_variants.vcf"))
    out = {"run_wall_s": wall, **res.summary()}
    _log(f"[c] golden gates pass: {json.dumps(out)}")
    return out


def phase_scale(work: str) -> dict:
    import jax

    from volcanosv_tpu.utils.logging import STAGE_TIMES
    scale_run = _repo_module("tools/scale_run.py")
    STAGE_TIMES.clear()
    report_path = os.path.join(work, "scale.json")
    rc = scale_run.main(["--mb", str(SCALE_MB), "--coverage", "24",
                         "--work", os.path.join(work, "scale"),
                         "--out", report_path])
    if rc != 0:
        raise RuntimeError(f"scale run failed ({rc})")
    with open(report_path) as fh:
        rep = json.load(fh)
    rep["peak_device_bytes"] = _peak(jax.devices()[0])
    _log(f"[d] scale {SCALE_MB} Mb x 24x: {json.dumps(rep)}")
    if rep["accuracy"]["f1"] < 0.97:
        raise AssertionError(f"scale F1 {rep['accuracy']['f1']} < 0.97")
    return rep


def phase_four_cards(work: str) -> dict:
    import jax

    from volcanosv_tpu import cli
    from volcanosv_tpu.eval import evaluate_files
    from volcanosv_tpu.ops.banded_align import banded_align_cigars
    from volcanosv_tpu.parallel.mesh import make_mesh, set_active_mesh

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four_cards needs 4 GPUs, JAX sees {len(devs)}")

    # one card: the same process with no mesh (everything on device 0)
    real_mesh = cli._pipeline_mesh
    cli._pipeline_mesh = lambda: None
    try:
        sim_dir, out1, wall1 = _sim_and_run(work, "one_card")
    finally:
        cli._pipeline_mesh = real_mesh
    base = [_peak(d) for d in devs]
    _sim, out4, wall4 = _sim_and_run(work, "four_cards")
    set_active_mesh(None)
    peaks = [_peak(d) for d in devs]
    _log(f"[4] peak device bytes after the 1-card run {base}, "
         f"after the 4-card run {peaks}")
    if not all(p > b for p, b in zip(peaks[1:], base[1:])):
        raise AssertionError("the 4-card run left devices 1-3 unused")

    vcf = "volcanosv_variants.vcf"
    recs = []
    for out_dir in (out1, out4):
        with open(os.path.join(out_dir, vcf)) as fh:
            recs.append([ln for ln in fh if not ln.startswith("#")])
    if recs[0] != recs[1]:
        raise AssertionError(f"4-card VCF differs from 1-card VCF "
                             f"({len(recs[1])} vs {len(recs[0])} records)")
    truth = os.path.join(sim_dir, "truth.vcf")
    acc1 = evaluate_files(truth, os.path.join(out1, vcf)).summary()
    acc4 = evaluate_files(truth, os.path.join(out4, vcf)).summary()

    # sharded DP vs the single-device kernel on one refine batch
    rng = np.random.default_rng(3)
    q, t, qlen, tlen, _ = _pairs(rng, 1024, 1024, 1280)
    kw = dict(W=256, d_lo=-128, scores=_scores("map-hifi"))
    set_active_mesh(make_mesh())
    sharded = banded_align_cigars(q, t, qlen, tlen, **kw)
    set_active_mesh(None)
    single = banded_align_cigars(q, t, qlen, tlen, **kw)
    if sharded != single:
        raise AssertionError("sharded DP CIGARs differ from one device's")
    _log("[4] sharded DP CIGARs == single-device CIGARs (1024 windows)")
    out = {"records": len(recs[0]), "one_card_wall_s": wall1,
           "four_card_wall_s": wall4, "wall_ratio_1_to_4": wall1 / wall4,
           "one_card": acc1, "four_cards": acc4}
    _log(f"[4] VCFs identical record for record: {json.dumps(out)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four_cards", action="store_true",
                    help="run only the 4-card mesh path")
    args = ap.parse_args(argv)

    device = phase_preflight()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            phase_four_cards(work)
        else:
            phase_kernel()
            phase_golden(work)
            phase_scale(work)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
