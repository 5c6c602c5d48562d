"""The Hopper banded-DP and walk kernels (ops/gpu/banded_dp.cuh), compiled
for the host under the warp emulator in tests/gpu_host_emu.cpp, against
banded_align_scan and traceback_cigar: scores, end columns, diagonal-0
profiles, every traceback row a walk can read, and the walked CIGARs.
This holds the CUDA source's arithmetic and lane/warp exchanges to the
oracle on machines without a card; the card itself is covered by the
`gpu`-marked tests and chip_smoke.py."""
import ctypes
import os
import subprocess

import numpy as np
import pytest

from volcanosv_tpu.ops.banded_align import (Scores, _rle_columns, _unpack_ops,
                                            banded_align_scan,
                                            traceback_cigar)
from volcanosv_tpu.ops import gpu

from test_dp_kernel import ASM20, _pairs

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("emu") / "emu.so")
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-pthread", "-I", os.path.dirname(gpu.__file__),
                    os.path.join(HERE, "gpu_host_emu.cpp"), "-o", out],
                   check=True, capture_output=True)
    return ctypes.CDLL(out)


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("B,M,W,d_lo,scores,free,row0", [
    (8, 64, 64, -32, Scores(), False, False),
    (8, 64, 32, -16, Scores(), False, True),
    (6, 48, 128, -64, ASM20, False, False),
    (5, 40, 64, -32, Scores(), True, False),
    (4, 40, 64, -32, Scores.edit(), False, False),
    (3, 50, 256, -128, ASM20, False, True),
    (2, 40, 512, -256, Scores(), False, True),
    (2, 40, 512, -256, ASM20, True, False),
], ids=["w64", "w32-row0", "w128-dual", "w64-free", "w64-edit",
        "w256-dual-row0", "w512-2warps-row0", "w512-2warps-dual-free"])
def test_emulated_kernel_matches_scan(emu, B, M, W, d_lo, scores, free, row0):
    rng = np.random.default_rng(B * M + W)
    N = M + W
    q, t, qlen, tlen = _pairs(rng, B, M, N)
    s = np.zeros(B, np.int32)
    e = np.zeros(B, np.int32)
    tb = np.zeros((M, B, W), np.uint8)
    r0 = np.zeros((M, B), np.int32) if row0 else None
    assert emu.emu_banded_dp(
        _ptr(q), _ptr(t), _ptr(qlen), _ptr(tlen), B, M, N, W, d_lo,
        scores.match, scores.mismatch, scores.gap_open, scores.gap_extend,
        scores.gap_open2 or 0, scores.gap_extend2 or 0, int(scores.dual),
        int(free), _ptr(s), _ptr(e), _ptr(tb), _ptr(r0)) == 0
    out = banded_align_scan(q, t, qlen, tlen, W=W, d_lo=d_lo, scores=scores,
                            free_t_end=free, row0_scores=row0)
    s_ref, tb_ref, e_ref = (np.asarray(x) for x in out[:3])
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(e, e_ref)
    if row0:
        np.testing.assert_array_equal(r0, np.asarray(out[3]))
    live = (np.arange(M)[:, None] < qlen[None, :])[:, :, None]
    np.testing.assert_array_equal(np.where(live, tb, 0),
                                  np.where(live, tb_ref, 0))
    n_steps = -(-(3 * M + W + 4) // 4) * 4
    ops = np.zeros((n_steps // 4, B), np.uint8)
    emu.emu_walk(_ptr(tb), _ptr(qlen), _ptr(tlen), M, B, W, d_lo, n_steps,
                 _ptr(ops))
    cigs = _rle_columns(_unpack_ops(ops), B)
    for b in range(B):
        assert cigs[b] == traceback_cigar(tb_ref[:, b], int(qlen[b]),
                                          int(tlen[b]), d_lo=d_lo), b
