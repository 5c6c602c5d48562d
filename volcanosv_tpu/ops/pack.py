"""2-bit base encoding + ragged-batch padding.

Generalizes the reference's one-hot k-mer trick (HashSeq.py:30-38
ONE_HOT_MAP {A:00, C:01, G:10, T:11}) into the framework-wide sequence
representation: int8 codes A=0 C=1 G=2 T=3, N/other=4.  All device kernels
consume these codes; strings never reach the device.
"""
from __future__ import annotations

import numpy as np

CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4

_LUT = np.full(256, CODE_N, dtype=np.int8)
for i, c in enumerate("ACGT"):
    _LUT[ord(c)] = i
    _LUT[ord(c.lower())] = i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = np.array([CODE_T, CODE_G, CODE_C, CODE_A, CODE_N], dtype=np.int8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """ASCII sequence → int8 codes (vectorized lookup)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_codes(codes: np.ndarray) -> str:
    return _DECODE[np.clip(codes, 0, 4)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes[::-1]]


def revcomp_seq(seq: str) -> str:
    return decode_codes(revcomp_codes(encode_seq(seq)))


def pad_codes(seqs: list[np.ndarray], pad_to: int | None = None,
              pad_value: int = CODE_N) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged code arrays into (B, L) + lengths.  L rounded up to a
    multiple of 128 (fewer distinct compiled shapes) unless pad_to given."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    if pad_to is None:
        m = int(lens.max()) if len(lens) else 1
        pad_to = max(128, -(-m // 128) * 128)
    out = np.full((len(seqs), pad_to), pad_value, dtype=np.int8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s[:pad_to]
    return out, lens


def bucket_by_length(lengths: np.ndarray, bucket_edges: list[int]) -> list[np.ndarray]:
    """Indices grouped into length buckets (for pad-and-batch dispatch)."""
    out = []
    prev = 0
    lengths = np.asarray(lengths)
    for edge in bucket_edges:
        sel = np.nonzero((lengths > prev) & (lengths <= edge))[0]
        out.append(sel)
        prev = edge
    out.append(np.nonzero(lengths > prev)[0])
    return out
