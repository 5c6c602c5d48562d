"""Hopper kernels for the banded DP (banded_dp.cuh) and their JAX bindings.

nvcc builds banded_dp.cu for sm_90a at first use, into build/ under a hash
of the sources; the library registers two XLA FFI targets, the DP and the
traceback walk.  The wrappers below only describe the calls (shapes and
attributes), so they trace and evaluate abstractly on any backend; running
them needs the library, which `register()` builds and loads.  A failed
build raises: there is no fallback on a GPU host.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("banded_dp.cu", "banded_dp.cuh")
GENCODE = "arch=compute_90a,code=sm_90a"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def nvcc_command(out: str) -> list[str]:
    """The build command: the committed .cu file (which includes the .cuh)
    and JAX's FFI headers, nothing else."""
    return [_nvcc(), "-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-I", _HERE, "-I", jax.ffi.include_dir(),
            "-o", out, os.path.join(_HERE, SOURCES[0])]


def lib_path() -> str:
    h = hashlib.sha256(GENCODE.encode())
    for s in SOURCES:
        with open(os.path.join(_HERE, s), "rb") as fh:
            h.update(fh.read())
    return os.path.join(_HERE, "build", f"libvsv_gpu_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library if this source hash has not been built yet."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def register() -> str:
    """Build, load and register the FFI targets once per process."""
    path = build()
    lib = ctypes.cdll.LoadLibrary(path)
    jax.ffi.register_ffi_target("vsv_banded_dp",
                                jax.ffi.pycapsule(lib.VsvBandedDp),
                                platform="CUDA")
    jax.ffi.register_ffi_target("vsv_walk", jax.ffi.pycapsule(lib.VsvWalk),
                                platform="CUDA")
    return path


def check_band(W: int, d_lo: int) -> None:
    """The band shapes the kernel has a launch shape for (dp_launch)."""
    if not (W in (32, 64, 128) or (W % 256 == 0 and W <= 4096)):
        raise ValueError(f"W={W}: need 32, 64, 128 or a multiple of 256 "
                         f"up to 4096")
    if not -W < d_lo <= 0:
        raise ValueError(f"d_lo={d_lo}: need -W < d_lo <= 0")


@functools.partial(
    jax.jit,
    static_argnames=("W", "d_lo", "scores", "with_traceback", "free_t_end",
                     "row0_scores"))
def banded_dp(q, t, qlen, tlen, *, W: int, d_lo: int, scores,
              with_traceback: bool = True, free_t_end: bool = False,
              row0_scores: bool = False):
    """banded_align_scan on the card: (score (B,), tb (M, B, W) uint8 |
    None, end_j (B,), row0 (M, B) | None).  Rows at or past qlen of tb
    are left unwritten; nothing reads them."""
    check_band(W, d_lo)
    B, M = q.shape
    out = (jax.ShapeDtypeStruct((B,), jnp.int32),
           jax.ShapeDtypeStruct((B,), jnp.int32),
           jax.ShapeDtypeStruct((M, B, W) if with_traceback else (0,),
                                jnp.uint8),
           jax.ShapeDtypeStruct((M, B) if row0_scores else (0,), jnp.int32))
    i32 = np.int32
    score, end_j, tb, row0 = jax.ffi.ffi_call("vsv_banded_dp", out)(
        q.astype(jnp.int8), t.astype(jnp.int8), qlen.astype(jnp.int32),
        tlen.astype(jnp.int32), W=i32(W), d_lo=i32(d_lo),
        match=i32(scores.match), mismatch=i32(scores.mismatch),
        go=i32(scores.gap_open), ge=i32(scores.gap_extend),
        go2=i32(scores.gap_open2 or 0), ge2=i32(scores.gap_extend2 or 0),
        dual=i32(scores.dual), free_t_end=i32(free_t_end))
    return (score, tb if with_traceback else None, end_j,
            row0 if row0_scores else None)


def walk(tb, qlen, tlen, d_lo: int, n_steps: int):
    """Traceback walk of a (M, B, W) traceback, one thread per alignment:
    the packed reverse-order op stream (n_steps // 4, B) uint8 that
    banded_align._walk_device(pack=True) returns."""
    assert n_steps % 4 == 0, n_steps
    B = tb.shape[1]
    return jax.ffi.ffi_call(
        "vsv_walk", jax.ShapeDtypeStruct((n_steps // 4, B), jnp.uint8))(
        tb, qlen.astype(jnp.int32), tlen.astype(jnp.int32),
        d_lo=np.int32(d_lo))
