"""Device-side traceback walk (_walk_device) vs the host walk, on the CPU
backend — banded_align_cigars walks every traceback with this state
machine (or the GPU walk kernel that mirrors it), so its logic is pinned
here against traceback_cigar."""
import numpy as np
import jax.numpy as jnp

from volcanosv_tpu.ops.banded_align import (Scores, _rle_column,
                                            _walk_device, banded_align_scan,
                                            traceback_cigar)


def _random_pairs(rng, B, M, W):
    N = M + W
    q = rng.integers(0, 4, (B, M), dtype=np.int8)
    t = np.empty((B, N), np.int8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        L = int(rng.integers(10, M))
        qlen[b] = L
        seq = list(q[b, :L])
        for _ in range(int(rng.integers(0, 10))):
            p = int(rng.integers(0, max(len(seq), 1)))
            r = rng.random()
            if r < 0.4 and p < len(seq):
                seq[p] = int(rng.integers(0, 4))
            elif r < 0.7:
                seq.insert(p, int(rng.integers(0, 4)))
            elif len(seq) > 4 and p < len(seq):
                del seq[p]
        seq = seq[:N]
        tlen[b] = len(seq)
        t[b, :len(seq)] = seq
        t[b, len(seq):] = rng.integers(0, 4, N - len(seq))
    return q, t, qlen, tlen


def test_walk_device_matches_host_walk(rng):
    B, M, W, d_lo = 16, 128, 64, -32
    q, t, qlen, tlen = _random_pairs(rng, B, M, W)
    _s, tb, _e = banded_align_scan(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                   scores=Scores())
    tb_np = np.asarray(tb)                       # (M, B, W)
    n_steps = 2 * M + 3 * W + 10
    ops, done = _walk_device(tb, jnp.asarray(qlen),
                             jnp.asarray(tlen), d_lo, n_steps)
    ops = np.asarray(ops)
    assert bool(np.all(np.asarray(done)))
    for b in range(B):
        got = _rle_column(ops[:, b])
        want = traceback_cigar(tb_np[:, b], int(qlen[b]), int(tlen[b]),
                               d_lo=d_lo)
        assert got == want, (b, got[:4], want[:4])


def test_walk_device_packed_matches_unpacked(rng):
    from volcanosv_tpu.ops.banded_align import _unpack_ops
    B, M, W, d_lo = 16, 128, 64, -32
    q, t, qlen, tlen = _random_pairs(rng, B, M, W)
    _s, tb, _e = banded_align_scan(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                   scores=Scores())
    n_steps = 2 * M + 3 * W + 12            # multiple of 4
    plain = np.asarray(_walk_device(tb, jnp.asarray(qlen),
                                    jnp.asarray(tlen), d_lo, n_steps)[0])
    packed = np.asarray(_walk_device(tb, jnp.asarray(qlen),
                                     jnp.asarray(tlen), d_lo, n_steps,
                                     pack=True)[0])
    assert packed.shape == (n_steps // 4, B)
    np.testing.assert_array_equal(_unpack_ops(packed), plain)


def test_walk_device_consumes_exact_lengths(rng):
    B, M, W, d_lo = 8, 64, 32, -16
    q, t, qlen, tlen = _random_pairs(rng, B, M, W)
    _s, tb, _e = banded_align_scan(q, t, qlen, tlen, W=W, d_lo=d_lo,
                                   scores=Scores())
    ops = np.asarray(_walk_device(tb, jnp.asarray(qlen),
                                  jnp.asarray(tlen), d_lo,
                                  2 * M + 3 * W + 10)[0])
    for b in range(B):
        cig = _rle_column(ops[:, b])
        qc = sum(ln for op, ln in cig if op in (0, 1))
        tc = sum(ln for op, ln in cig if op in (0, 2))
        assert qc == int(qlen[b]) and tc == int(tlen[b])
