"""The banded-DP kernel choice per platform, the GPU kernel's JAX wrapper
(abstract shapes only: no card needed), the device traceback walk behind
banded_align_cigars, the compile-cache rule and the smoke script's refusal
to run without a GPU.  Kernel-vs-scan tests on a card are marked `gpu`."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import volcanosv_tpu
from volcanosv_tpu.ops import banded_align as ba
from volcanosv_tpu.ops import gpu
from volcanosv_tpu.ops.banded_align import (SCAN, Scores, banded_align_cigars,
                                            banded_align_scan, dp_kernel,
                                            traceback_cigar)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASM20 = Scores(match=2, mismatch=-2, gap_open=-4, gap_extend=-2,
               gap_open2=-24, gap_extend2=-1)


def _pairs(rng, B, M, N):
    """Targets = query with substitutions and short indels; row 3 random."""
    q = rng.integers(0, 4, (B, M), dtype=np.int8)
    t = np.full((B, N), 4, np.int8)
    qlen = rng.integers(M // 3, M + 1, B).astype(np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        s = list(q[b, :qlen[b]])
        for _ in range(int(rng.integers(0, 8))):
            p = int(rng.integers(0, max(len(s), 1)))
            r = rng.random()
            if r < .4 and p < len(s):
                s[p] = int(rng.integers(0, 4))
            elif r < .7:
                s[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 6))))
            elif p < len(s):
                del s[p:p + int(rng.integers(1, 6))]
        if b == 3:
            s = list(rng.integers(0, 4, int(rng.integers(1, N))))
        s = s[:N]
        tlen[b] = len(s)
        t[b, :len(s)] = s
    return q, t, qlen, tlen


def test_dp_kernel_is_scan_on_cpu():
    assert dp_kernel("cpu") is SCAN
    assert dp_kernel() is SCAN           # the tests run on the CPU backend


def test_dp_kernel_refuses_unknown_platform(monkeypatch):
    class FakeDevice:
        platform = "fake"
        device_kind = "fake"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    with pytest.raises(RuntimeError, match="no banded-DP kernel"):
        dp_kernel()


@pytest.mark.parametrize("kw,W,B", [
    (dict(with_traceback=True), 256, 37),
    (dict(with_traceback=False), 128, 5),
    (dict(with_traceback=False, row0_scores=True), 128, 33),
    (dict(with_traceback=True, scores=ASM20), 64, 7),
    (dict(with_traceback=False, free_t_end=True), 1024, 3),
])
def test_gpu_wrapper_shapes(kw, W, B):
    """Abstract evaluation of the FFI call: outputs keep the caller's
    (odd) batch, the traceback is (M, B, W), row0 is (M, B)."""
    kw = {"scores": Scores(), **kw}
    M = 96
    spec = (jax.ShapeDtypeStruct((B, M), jnp.int8),
            jax.ShapeDtypeStruct((B, M + W), jnp.int8),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((B,), jnp.int32))
    score, tb, end_j, row0 = jax.eval_shape(
        lambda q, t, ql, tl: gpu.banded_dp(q, t, ql, tl, W=W, d_lo=-(W // 2),
                                           **kw), *spec)
    assert score.shape == end_j.shape == (B,)
    assert score.dtype == end_j.dtype == jnp.int32
    if kw.get("with_traceback"):
        assert (tb.shape, tb.dtype) == ((M, B, W), jnp.uint8)
        ops = jax.eval_shape(lambda t_, ql, tl: gpu.walk(t_, ql, tl, -W // 2,
                                                         400), tb, *spec[2:])
        assert (ops.shape, ops.dtype) == ((100, B), jnp.uint8)
    else:
        assert tb is None
    if kw.get("row0_scores"):
        assert (row0.shape, row0.dtype) == ((M, B), jnp.int32)
    else:
        assert row0 is None


@pytest.mark.parametrize("W,d_lo", [(96, -48), (384, -192), (8192, -4096),
                                    (64, 1), (64, -64)])
def test_gpu_wrapper_rejects_bands_without_launch_shape(W, d_lo):
    with pytest.raises(ValueError):
        gpu.check_band(W, d_lo)


@pytest.mark.parametrize("scores", [Scores(), ASM20], ids=["single", "dual"])
def test_banded_align_cigars_device_walk(rng, scores):
    """banded_align_cigars (DP + on-device walk + packed op stream) gives
    the host walk's CIGARs for every row."""
    B, M, W, d_lo = 24, 96, 64, -32
    q, t, qlen, tlen = _pairs(rng, B, M, M + W)
    cigs = banded_align_cigars(q, t, qlen, tlen, W=W, d_lo=d_lo,
                               scores=scores)
    _s, tb, _e = banded_align_scan(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                   scores=scores)
    tb = np.asarray(tb)
    for b in range(B):
        assert cigs[b] == traceback_cigar(tb[:, b], int(qlen[b]),
                                          int(tlen[b]), d_lo=d_lo), b


def test_compile_cache_env_wins(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    try:
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        assert volcanosv_tpu.configure_compile_cache() is None
        assert jax.config.jax_compilation_cache_dir == "sentinel"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        d = volcanosv_tpu.configure_compile_cache()
        assert d == volcanosv_tpu.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == d
        assert os.path.dirname(d) == REPO
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert os.path.basename(d) + "/" in fh.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_nvcc_command_builds_committed_sources_for_sm90a():
    cmd = gpu.nvcc_command("out.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    here = os.path.dirname(gpu.__file__)
    srcs = [a for a in cmd if a.endswith((".cu", ".cuh", ".cpp"))]
    assert srcs == [os.path.join(here, "banded_dp.cu")]
    # every CUDA source in the directory is hashed into the library name
    on_disk = sorted(f for f in os.listdir(here) if f.endswith((".cu", ".cuh")))
    assert on_disk == sorted(gpu.SOURCES)
    assert os.path.dirname(gpu.lib_path()) == os.path.join(here, "build")


def _run_smoke(cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("W,d_lo,M,B,scores,mode", [
    (256, -128, 512, 300, Scores(), "tb"),
    (256, -128, 512, 300, ASM20, "tb"),
    (128, -64, 256, 257, Scores(), "row0"),
    (64, -32, 256, 1000, Scores(), "tb"),
    (1024, -512, 300, 17, Scores.edit(), "free"),
])
def test_cuda_kernel_matches_scan(gpu_device, W, d_lo, M, B, scores, mode):
    """On a card: the Hopper kernel against the scan, bit for bit."""
    rng = np.random.default_rng(W + B)
    q, t, qlen, tlen = _pairs(rng, B, M, M + W)
    kern = dp_kernel()
    assert kern.name == "cuda"
    kw = dict(W=W, d_lo=d_lo, scores=scores, with_traceback=mode == "tb",
              row0_scores=mode == "row0", free_t_end=mode == "free")
    got = [None if x is None else np.asarray(x)
           for x in kern.align(q, t, qlen, tlen, **kw)]
    want = [None if x is None else np.asarray(x)
            for x in SCAN.align(q, t, qlen, tlen, **kw)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    if mode == "row0":
        np.testing.assert_array_equal(got[3], want[3])
    if mode == "tb":
        n_steps, _ = ba._walk_steps(M, W, qlen, tlen)
        np.testing.assert_array_equal(
            np.asarray(kern.walk(jnp.asarray(got[1]), qlen, tlen, d_lo,
                                 n_steps)),
            np.asarray(SCAN.walk(jnp.asarray(want[1]), qlen, tlen, d_lo,
                                 n_steps)))
