"""Banded-DP benchmark on one GPU, plus end-to-end read alignment.

The DP kernel backs every alignment path in the engine (contig→ref,
reads→ref, polish, edit distance — ops/banded_align.py, ops/gpu), i.e. it
plays the role minimap2's ksw2 plays for the reference pipeline.  The
benchmark times whatever kernel ops.banded_align.dp_kernel picks for the
platform, and fails when JAX finds no GPU.

GCUPS counts the padded batch's banded cells, B x M x W, per second.

Output: supporting metrics go to stderr, one JSON line each; stdout gets
EXACTLY ONE JSON line, the headline, with the device it ran on.

    python bench.py
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def _time_best(fn, n_iter=5, n_batches=3):
    """Best mean-batch seconds after one warm-up (compile) call."""
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(n_batches):
        t0 = time.perf_counter()
        out = None
        for _ in range(n_iter):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n_iter)
    return best


def bench_dp(with_traceback: bool):
    """(gcups, kernel name) for the banded DP at the refine shape
    B=1024, M=2048, W=256 (aligner._RefinePipeline's 2048-row bucket)."""
    import jax.numpy as jnp

    from volcanosv_tpu.ops.banded_align import Scores, dp_kernel

    kern = dp_kernel()
    W, d_lo = 256, -128
    B, M = 1024, 2048
    N = M + W
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, 4, (B, M), dtype=np.int8))
    t = jnp.asarray(rng.integers(0, 4, (B, N), dtype=np.int8))
    qlen = jnp.full((B,), M, jnp.int32)
    tlen = jnp.full((B,), M + 64, jnp.int32)

    def run():
        s, tb, ej, _ = kern.align(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                  scores=Scores(),
                                  with_traceback=with_traceback)
        return (s, ej) if tb is None else (s, tb, ej)

    dt = _time_best(run)
    return B * M * W / dt / 1e9, kern.name


def bench_reads_aligned():
    """End-to-end reads/s and bp/s through Aligner.align (sketch → chain →
    banded DP → CIGAR), the pipeline's map-hifi read-alignment path, on
    2000 × 8 kb reads over an 800 kb reference."""
    from volcanosv_tpu.aligner import Aligner
    from volcanosv_tpu.config import AlignConfig
    from volcanosv_tpu.sim import random_genome, simulate_reads

    rng = np.random.default_rng(1)
    ref = random_genome(rng, 800_000)
    reads = simulate_reads(rng, {1: ref}, coverage=20.0,
                           read_len=8_000, sub_rate=0.002, indel_rate=0.001)
    read_seqs = [(n, s) for n, s, *_ in reads]
    total_bp = sum(len(s) for _, s in read_seqs)
    aligner = Aligner(ref, AlignConfig.preset("map-hifi"))
    aligner.align(read_seqs)                  # warm: compile bucket shapes
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        alns = aligner.align(read_seqs)
        best = min(best, time.perf_counter() - t0)
    n_aln = len({a.qname for a in alns if not a.is_supplementary})
    return len(read_seqs) / best, total_bp / best, n_aln, len(read_seqs)


def main() -> None:
    from volcanosv_tpu.utils.device import gpu_name_power, require_gpu

    device = require_gpu()
    device["card"] = gpu_name_power()
    gcups_s, kernel = bench_dp(with_traceback=False)
    gcups_t, _ = bench_dp(with_traceback=True)
    reads_s, bp_s, n_aln, n_reads = bench_reads_aligned()
    detail = {
        "kernel": kernel,
        "banded_dp_score_gcups": gcups_s,
        "banded_dp_traceback_gcups": gcups_t,
        "reads_aligned_per_s": reads_s,
        "read_bp_aligned_per_s": bp_s,
        "reads_mapped_frac": n_aln / max(n_reads, 1),
    }
    for k, v in detail.items():
        print(json.dumps({"metric": k, "value": v}), file=sys.stderr)
    print(json.dumps({"metric": "banded_dp_throughput", "value": gcups_s,
                      "unit": "GCUPS", "device": device}))


if __name__ == "__main__":
    main()
