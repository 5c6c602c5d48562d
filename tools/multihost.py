"""Real multi-process (2-host) test of the pipeline's distributed layer.

Spawns N python processes that join ONE jax.distributed process group over
a localhost coordinator (CPU backend, 4 virtual devices per process), then
exercises the pipeline's actual multi-host path end to end:

  * `init_multihost`        — every process joins the group
  * `host_chromosome_shard` — each host owns a disjoint chromosome share
                              (the '22 SLURM jobs' replacement)
  * `gather_across_processes` + `wgs_global_median` — the WGS coverage
    median from PER-HOST-DISTINCT rel_cov vectors (each host contributes
    different data, exactly what chromosome sharding produces), validated
    against the union median
  * `build_sharded_align_step` — one sharded DP step over the global mesh
    (NVLink / network collectives in the real deployment)
  * **the real vc-large-indel driver** — both processes run
    `cli vc-large-indel` into one shared out_dir: query-sharded alignment,
    shared-FS record exchange, global-median collective, per-host part
    VCFs, rank-0 merge.  The parent asserts the merged VCF is
    BYTE-IDENTICAL to a single-process run on the same inputs.

Writes MULTIHOST.json with per-host shard ownership, the cross-host median
check, step timings, and the pipeline byte-identity verdict.  Runnable
anywhere (no multi-GPU host needed):

  python tools/multihost.py            # parent: spawns 2 workers
  python tools/multihost.py --n 4      # 4 processes
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = 39617


def _sim_and_reference_run(work: str, full: bool = False) -> None:
    """Generate 2-chromosome sim data + the single-process reference VCF."""
    from volcanosv_tpu.cli import main
    sim_dir = os.path.join(work, "sim")
    assert main(["sim", "-o", sim_dir, "--length", "50000", "--chroms", "2",
                 "--n_del", "3", "--n_ins", "3", "--coverage", "24",
                 "--read_len", "6000", "--seed", "11"]) == 0
    assert main(["vc-large-indel", "--ref", f"{sim_dir}/ref.fa",
                 "--contig", f"{sim_dir}/true_contigs.fa",
                 "--fastq", f"{sim_dir}/reads.fastq",
                 "-o", os.path.join(work, "single")]) == 0
    assert main(["vc-small-indel", "--ref", f"{sim_dir}/ref.fa",
                 "--contig", f"{sim_dir}/true_contigs.fa",
                 "--fastq", f"{sim_dir}/reads.fastq",
                 "-o", os.path.join(work, "single_small")]) == 0
    assert main(["vc-complex-sv", "--ref", f"{sim_dir}/ref.fa",
                 "--contig", f"{sim_dir}/true_contigs.fa",
                 "--fastq", f"{sim_dir}/reads.fastq",
                 "--large_vcf",
                 os.path.join(work, "single", "volcanosv_large_indel.vcf"),
                 "-o", os.path.join(work, "single_cx")]) == 0
    if full:
        assert main(["run", "--ref", f"{sim_dir}/ref.fa",
                     "--fastq", f"{sim_dir}/reads.fastq",
                     "-o", os.path.join(work, "single_run")]) == 0


def worker(pid: int, n: int, devs_per_proc: int, work: str,
           full: bool = False) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from volcanosv_tpu.parallel.mesh import (host_chromosome_shard,
                                             init_multihost, make_mesh)
    ok = init_multihost(coordinator_address=f"127.0.0.1:{PORT}",
                        num_processes=n, process_id=pid)
    assert ok, "process group init failed"
    assert jax.process_count() == n
    assert len(jax.devices()) == n * devs_per_proc     # global device view

    chroms = [f"chr{i}" for i in range(1, 23)]
    own = host_chromosome_shard(chroms)

    import numpy as np

    from volcanosv_tpu.parallel import build_sharded_align_step
    from volcanosv_tpu.parallel.mesh import batch_sharding
    from volcanosv_tpu.parallel.multiproc import gather_across_processes
    from volcanosv_tpu.parallel.wgs import wgs_global_median

    mesh = make_mesh()                                  # global mesh
    # every process contributes DIFFERENT rel_cov vectors (the per-host
    # chromosome shards carry distinct data in a real run); the union
    # median must equal the median of all hosts' values concatenated
    def host_vals(p: int) -> np.ndarray:
        r = np.random.default_rng(100 + p)
        return r.uniform(0, 4, 11 + 7 * p).astype(np.float32)

    glob = gather_across_processes(host_vals(pid))
    want_all = np.concatenate([host_vals(p) for p in range(n)])
    assert glob.shape == want_all.shape
    np.testing.assert_array_equal(np.sort(glob), np.sort(want_all))
    med = wgs_global_median([glob], None)
    want = float(np.median(want_all))
    assert abs(med - want) < 1e-5, (med, want)

    rng = np.random.default_rng(7)
    step = build_sharded_align_step(mesh, W=64, d_lo=-32, k=6)
    B, M = 4 * len(jax.devices()), 128
    sh = batch_sharding(mesh)
    def gput(x):
        return jax.make_array_from_process_local_data(sh, x)
    q = gput(rng.integers(0, 4, (B, M), dtype=np.int8))
    t = gput(rng.integers(0, 4, (B, M + 64), dtype=np.int8))
    qlen = gput(np.full((B,), M, np.int32))
    tlen = gput(np.full((B,), M + 8, np.int32))
    t0 = time.perf_counter()
    out = step(q, t, qlen, tlen)
    jax.block_until_ready(out)
    step_s = time.perf_counter() - t0

    # ---- the real pipeline across the process group ----
    from volcanosv_tpu.cli import main
    sim_dir = os.path.join(work, "sim")
    t0 = time.perf_counter()
    rc = main(["vc-large-indel", "--ref", f"{sim_dir}/ref.fa",
               "--contig", f"{sim_dir}/true_contigs.fa",
               "--fastq", f"{sim_dir}/reads.fastq",
               "-o", os.path.join(work, "multi")])
    pipeline_s = time.perf_counter() - t0
    assert rc == 0
    # the standalone small/complex drivers across the SAME process group
    # (round-3 verdict item 7): each host calls its shard, rank 0 merges
    assert main(["vc-small-indel", "--ref", f"{sim_dir}/ref.fa",
                 "--contig", f"{sim_dir}/true_contigs.fa",
                 "--fastq", f"{sim_dir}/reads.fastq",
                 "-o", os.path.join(work, "multi_small")]) == 0
    assert main(["vc-complex-sv", "--ref", f"{sim_dir}/ref.fa",
                 "--contig", f"{sim_dir}/true_contigs.fa",
                 "--fastq", f"{sim_dir}/reads.fastq",
                 "--large_vcf",
                 os.path.join(work, "multi", "volcanosv_large_indel.vcf"),
                 "-o", os.path.join(work, "multi_cx")]) == 0
    if full:
        # the FULL pipeline (asm + 3 vc paths + merge) across the group
        rc = main(["run", "--ref", f"{sim_dir}/ref.fa",
                   "--fastq", f"{sim_dir}/reads.fastq",
                   "-o", os.path.join(work, "multi_run")])
        assert rc == 0

    print(json.dumps({"pid": pid, "devices": len(jax.devices()),
                      "own_chroms": own, "median_ok": True,
                      "distinct_data_median": round(med, 6),
                      "step_s": round(step_s, 3),
                      "pipeline_s": round(pipeline_s, 1)}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--devs", type=int, default=4)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--work", default=None,
                    help="shared work dir (sim data + outputs)")
    ap.add_argument("--out", default=os.path.join(REPO, "MULTIHOST.json"))
    ap.add_argument("--full", action="store_true",
                    help="also run the FULL `run` pipeline (asm + 3 vc "
                         "paths) across the group and compare bytes")
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.n, args.devs, args.work, full=args.full)
        return
    import tempfile
    work = args.work or tempfile.mkdtemp(prefix="volcanosv_multihost_")

    env_base = dict(os.environ)
    env_base["PYTHONPATH"] = REPO
    env_base.pop("JAX_PLATFORMS", None)

    # single-process reference run (its own process: clean backend state)
    env = dict(env_base)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r); "
         "from tools.multihost import _sim_and_reference_run; "
         "_sim_and_reference_run(%r, full=%r)" % (REPO, work, args.full)],
        env=env, capture_output=True, text=True, timeout=1800, cwd=REPO)
    if r.returncode != 0:
        print(r.stderr[-3000:], file=sys.stderr)
        sys.exit(1)

    procs = []
    for pid in range(args.n):
        env = dict(env_base)
        env["JAX_PLATFORMS"] = "cpu"
        inherited = " ".join(
            f for f in env.get("XLA_FLAGS", "").split()
            if "host_platform_device_count" not in f)
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{args.devs} " + inherited).strip()
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(pid),
             "--n", str(args.n), "--devs", str(args.devs), "--work", work]
            + (["--full"] if args.full else []),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO))
    rows = []
    ok = True
    for p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        if p.returncode != 0:
            ok = False
            print(err[-3000:], file=sys.stderr)
            continue
        rows.append(json.loads(out.strip().splitlines()[-1]))
    # shard ownership must partition the chromosome set
    all_chroms = sorted(c for r in rows for c in r["own_chroms"])

    # the merged multi-process VCF must be byte-identical to single-process
    single_vcf = os.path.join(work, "single", "volcanosv_large_indel.vcf")
    multi_vcf = os.path.join(work, "multi", "volcanosv_large_indel.vcf")
    identical = False
    n_records = 0
    try:
        a, b = open(single_vcf, "rb").read(), open(multi_vcf, "rb").read()
        identical = a == b and len(a) > 0
        n_records = sum(1 for ln in a.splitlines() if not ln.startswith(b"#"))
    except OSError as e:
        print(f"pipeline output missing: {e}", file=sys.stderr)
    def _same(sub_a: str, sub_b: str, name: str):
        try:
            a = open(os.path.join(work, sub_a, name), "rb").read()
            b = open(os.path.join(work, sub_b, name), "rb").read()
            return a == b and len(a) > 0
        except OSError as e:
            print(f"{name} missing: {e}", file=sys.stderr)
            return False

    small_identical = _same("single_small", "multi_small",
                            "volcanosv_small_indel.vcf")
    cx_identical = _same("single_cx", "multi_cx",
                         "volcanosv_complex_sv.vcf")
    run_identical = None
    if args.full:
        run_identical = False
        try:
            a = open(os.path.join(work, "single_run",
                                  "volcanosv_variants.vcf"), "rb").read()
            b = open(os.path.join(work, "multi_run",
                                  "volcanosv_variants.vcf"), "rb").read()
            run_identical = a == b and len(a) > 0
        except OSError as e:
            print(f"full-run output missing: {e}", file=sys.stderr)

    result = {
        "n_processes": args.n,
        "devices_per_process": args.devs,
        "ok": ok and len(rows) == args.n
              and all_chroms == sorted(f"chr{i}" for i in range(1, 23))
              and identical and small_identical and cx_identical
              and run_identical is not False,
        "pipeline_vcf_identical": identical,
        "small_vcf_identical": small_identical,
        "complex_vcf_identical": cx_identical,
        "pipeline_vcf_records": n_records,
        "full_run_vcf_identical": run_identical,
        "rows": rows,
    }
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    sys.exit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
