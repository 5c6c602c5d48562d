"""The sharded per-step compute of the engine: batched banded DP + k-mer
tables + signature gathering over the device mesh.

This is the "training step" analogue of the pipeline — one jitted function
that runs the full device-side compute for a batch of alignment windows,
sharded over the (genome, data) mesh with real collectives:

  * banded affine DP over the window batch     (data parallel, both axes)
  * dense k-mer count table                    (psum over both axes — the
    global per-haplotype k-mer DB of the partition stage,
    count_kmer_v1.py equivalent)
  * per-shard SV signature score moments       (all_gather over "genome" —
    the WGS cross-shard signature merge, volcanosv-vc-large-indel.py:266-278
    equivalent)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.banded_align import Scores, dp_kernel
from ..ops.kmer import count_kmers_dense, kmer_hashes
from .mesh import AXES


def sharded_align_step(q, t, qlen, tlen, *, W: int, d_lo: int, k: int,
                       scores: Scores = Scores()):
    """Per-shard body. q/t: (b, M)/(b, N) local batch of DP windows."""
    score, _, end_j, _ = dp_kernel().align(
        q, t, qlen, tlen, W=W, d_lo=d_lo, scores=scores, with_traceback=False)
    # global k-mer count DB: local dense table + psum over the whole mesh
    h, valid = kmer_hashes(q, k)
    valid = valid & (jax.lax.broadcasted_iota(jnp.int32, h.shape, 1)
                     < (qlen[:, None] - k + 1))
    table = count_kmers_dense(h, valid, k)
    table = jax.lax.psum(table, (AXES.genome, AXES.data))
    # per-genome-shard alignment stats, gathered across shards
    local = jnp.stack([jnp.sum(score), jnp.max(score), jnp.sum(end_j)])
    per_shard = jax.lax.psum(local, AXES.data)
    gathered = jax.lax.all_gather(per_shard, AXES.genome)
    return score, table, gathered


def build_sharded_align_step(mesh: Mesh, *, W: int = 128, d_lo: int = -64,
                             k: int = 8):
    """jit(shard_map(step)) over the mesh. Batch dim split over both axes;
    k-mer table and shard stats replicated on exit."""
    spec_b = P((AXES.genome, AXES.data))
    fn = shard_map(
        functools.partial(sharded_align_step, W=W, d_lo=d_lo, k=k),
        mesh=mesh,
        in_specs=(spec_b, spec_b, spec_b, spec_b),
        out_specs=(spec_b, P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)
