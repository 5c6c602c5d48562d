// Banded (dual-)affine DP and traceback walk for NVIDIA Hopper.
//
// Semantics are exactly ops.banded_align.banded_align_scan's: the band is
// fixed in diagonal space (lane l <-> diagonal d = j - i = d_lo + l), row i
// reads the vertical predecessor at lane l+1 of row i-1, and the horizontal
// gap F is resolved exactly with an exclusive max-plus prefix over the row.
// Every value is int32 and every comparison is the scan's, so scores, end
// columns, diagonal-0 profiles and traceback bytes are bit-identical.
//
// Schedule: one warp per alignment for W <= 256.  Lane t holds K = W/32
// consecutive diagonals l = t*K .. t*K+K-1 of H, E and E2 in registers for
// the whole row loop, so the band never leaves the SM.  Per row:
//   * the vertical shift is an in-thread move plus one __shfl_down_sync;
//   * the F prefix max is an in-thread running max over the K diagonals,
//     then a 5-step __shfl_up_sync scan of the per-thread maxima;
//   * the target window slides by one column: an in-thread move plus one
//     __shfl_down_sync, and lane 31 loads the one new byte.
// Wider bands (edit distance up to W = 4096) use W/256 warps per alignment
// that exchange their boundary values through shared memory, two barriers
// per row.  Rows at or past qlen are never read back (the walk starts at
// row qlen-1), so the row loop stops at qlen; their diagonal-0 profile is
// written as NEG, which is what the scan yields there.
//
// This header holds device code only, so that it also compiles for the
// host (tests/test_gpu_kernel_host.py runs it under a warp emulator).
#pragma once

#include <cstdint>

namespace vsv {

constexpr int NEG = -500000000;            // == banded_align.NEG
constexpr int TB_DIAG = 0, TB_UP = 1, TB_LEFT = 2, TB_UP2 = 3, TB_LEFT2 = 4;
constexpr int TB_CHOICE = 7;
constexpr int TB_E_OPEN = 8, TB_F_OPEN = 16, TB_E2_OPEN = 32, TB_F2_OPEN = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_K = 8;                   // diagonals per lane
constexpr int MAX_WARPS = 16;              // warps per alignment: W <= 4096
constexpr int SMEM_INTS = 14 * MAX_WARPS;

struct DpParams {
  int B, M, N, W, d_lo;
  int match, mismatch, go, ge, go2, ge2;
  int free_t_end;
  const int8_t* q;        // (B, M)
  const int8_t* t;        // (B, N)
  const int32_t* qlen;    // (B,)
  const int32_t* tlen;    // (B,)
  int32_t* score;         // (B,)
  int32_t* end_j;         // (B,)
  uint8_t* tb;            // (M, B, W) or null
  int32_t* row0;          // (M, B) or null
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// max(a, b), and *ge = (a >= b): one DPX instruction on sm_90.
__device__ __forceinline__ int max_ge(int a, int b, bool* ge) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __vibmax_s32(a, b, ge);
#else
  *ge = a >= b;
  return a >= b ? a : b;
#endif
}

// max(a + b, c): one DPX instruction on sm_90.
__device__ __forceinline__ int add_max(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  return __viaddmax_s32(a, b, c);
#else
  return imax(a + b, c);
#endif
}

// Launch shape for band width W and batch B: K diagonals per lane, nw warps
// per alignment, and four alignments per 128-thread block when one warp
// holds the band.  False when W has no such shape.
struct DpLaunch {
  int K, nw, threads, grid;
};

inline bool dp_launch(int W, int B, DpLaunch* s) {
  const int K = W / 32 < MAX_K ? W / 32 : MAX_K;
  if (W < 32 || W % (32 * K) || (K & (K - 1)) || W / (32 * K) > MAX_WARPS)
    return false;
  s->K = K;
  s->nw = W / (32 * K);
  const int apb = s->nw == 1 ? 4 : 1;
  s->threads = 32 * s->nw * apb;
  s->grid = (B + apb - 1) / apb;
  return true;
}

template <bool DUAL>
__device__ __forceinline__ int gap_score(const DpParams& p, int k) {
  const int s = p.go + p.ge * k;
  return DUAL ? imax(s, p.go2 + p.ge2 * k) : s;
}

// Block = APB alignments x NW warps each (NW > 1 only with APB == 1).
template <int K, bool DUAL>
__global__ void __launch_bounds__(512) banded_dp_kernel(DpParams p) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = p.W / (32 * K);
  const int apb = blockDim.x / (32 * nw);
  const int wa = warp % nw;                      // warp within alignment
  const int b = blockIdx.x * apb + warp / nw;
  if (b >= p.B) return;                          // whole block when NW > 1

  const int W = p.W, d_lo = p.d_lo;
  const int L0 = wa * 32 * K + lane * K;         // first diagonal of lane
  const int qlen = p.qlen[b], tlen = p.tlen[b];
  const int8_t* qb = p.q + (size_t)b * p.M;
  const int8_t* tbase = p.t + (size_t)b * p.N;
  const int gog = p.go + p.ge, gog2 = p.go2 + p.ge2;
  const int l_star = imin(imax(tlen - qlen - d_lo, 0), W - 1);
  const int l_row0 = -d_lo;

  int H[K], E[K], E2[K], tw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int l = L0 + k;
    const int j = -1 + d_lo + l;               // row -1
    H[k] = j == -1 ? 0
         : ((j >= 0 && j < tlen) ? gap_score<DUAL>(p, j + 1) : NEG);
    E[k] = NEG;
    E2[k] = NEG;
    const int jt = d_lo + l;                     // row 0 target column
    tw[k] = (jt >= 0 && jt < p.N) ? (int)tbase[jt] : 4;
  }
  int best = NEG, best_j = 0;
  const int rows = imin(qlen, p.M);
  int* xu = smem;                    // [2][nw][3]: lane-0 H, E, E2
  int* xf = smem + 6 * MAX_WARPS;    // [2][nw][3]: prefix maxima, H_last
  int* xr = smem + 12 * MAX_WARPS;   // [nw][2]: free-end (max, lane)

  for (int i = 0; i < rows; ++i) {
    const int par = i & 1;
    if (i > 0) {                      // slide the target window one column
      int nxt = __shfl_down_sync(FULL, tw[0], 1);
      if (lane == 31) {
        const int jt = i + d_lo + L0 + K - 1;
        nxt = (jt >= 0 && jt < p.N) ? (int)tbase[jt] : 4;
      }
#pragma unroll
      for (int k = 0; k + 1 < K; ++k) tw[k] = tw[k + 1];
      tw[K - 1] = nxt;
    }
    const int qi = qb[i];

    // vertical predecessors: lane l+1 of row i-1
    int Hn = __shfl_down_sync(FULL, H[0], 1);
    int En = __shfl_down_sync(FULL, E[0], 1);
    int E2n = DUAL ? __shfl_down_sync(FULL, E2[0], 1) : NEG;
    if (nw > 1) {
      if (lane == 0) {
        int* s = xu + (par * MAX_WARPS + wa) * 3;
        s[0] = H[0]; s[1] = E[0]; s[2] = E2[0];
      }
      __syncthreads();
    }
    if (lane == 31) {
      if (wa + 1 < nw) {
        const int* s = xu + (par * MAX_WARPS + wa + 1) * 3;
        Hn = s[0]; En = s[1]; E2n = s[2];
      } else {
        Hn = NEG; En = NEG; E2n = NEG;
      }
    }

    // E, E2, Htmp and the in-thread part of the F prefix max
    const int lb = -1 - i - d_lo;                // column -1 boundary lane
    int Ht[K], ex[K], ex2[K], cb[K];
    int run = NEG, run2 = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = L0 + k;
      const int hup = k + 1 < K ? H[k + 1] : Hn;
      const int eup = k + 1 < K ? E[k + 1] : En;
      bool e_open;
      const int e = max_ge(hup + gog, eup + p.ge, &e_open);
      const int tv = tw[k];
      const int sub = (qi == tv && qi < 4 && tv < 4) ? p.match : p.mismatch;
      bool diag;
      int ht = max_ge(H[k] + sub, e, &diag);
      int c = (diag ? TB_DIAG : TB_UP) | (e_open ? TB_E_OPEN : 0);
      E[k] = e;
      if (DUAL) {
        const int e2up = k + 1 < K ? E2[k + 1] : E2n;
        bool e2_open, keep;
        const int e2 = max_ge(hup + gog2, e2up + p.ge2, &e2_open);
        ht = max_ge(ht, e2, &keep);
        if (!keep) c = (c & ~TB_CHOICE) | TB_UP2;
        if (e2_open) c |= TB_E2_OPEN;
        E2[k] = e2;
      }
      if (l == lb) ht = gap_score<DUAL>(p, i + 1);
      Ht[k] = ht;
      cb[k] = c;
      ex[k] = run;
      run = add_max(ht, -p.ge * l, run);
      if (DUAL) {
        ex2[k] = run2;
        run2 = add_max(ht, -p.ge2 * l, run2);
      }
    }

    // warp scan of the per-thread maxima -> exclusive carry into the lane
    int v = run, v2 = run2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(FULL, v, off);
      const int n2 = DUAL ? __shfl_up_sync(FULL, v2, off) : NEG;
      if (lane >= off) {
        v = imax(v, n);
        v2 = imax(v2, n2);
      }
    }
    int cin = __shfl_up_sync(FULL, v, 1);
    int cin2 = DUAL ? __shfl_up_sync(FULL, v2, 1) : NEG;
    int hl = __shfl_up_sync(FULL, Ht[K - 1], 1);
    if (lane == 0) {
      cin = NEG; cin2 = NEG; hl = NEG;
    }
    if (nw > 1) {
      if (lane == 31) {
        int* s = xf + (par * MAX_WARPS + wa) * 3;
        s[0] = v; s[1] = v2; s[2] = Ht[K - 1];
      }
      __syncthreads();
      for (int w2 = 0; w2 < wa; ++w2) {
        const int* s = xf + (par * MAX_WARPS + w2) * 3;
        cin = imax(cin, s[0]);
        cin2 = imax(cin2, s[1]);
      }
      if (lane == 0 && wa > 0) hl = xf[(par * MAX_WARPS + wa - 1) * 3 + 2];
    }

    // F, F2, the new H row, masks and outputs
    const bool last = i == qlen - 1;
    int tbv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int l = L0 + k;
      const int hleft = k ? Ht[k - 1] : hl;
      int c = cb[k];
      const int f = imax(cin, ex[k]) + p.ge * l + p.go;
      if (hleft + gog >= f) c |= TB_F_OPEN;
      bool keep;
      int h = max_ge(Ht[k], f, &keep);
      if (!keep) c = (c & ~TB_CHOICE) | TB_LEFT;
      if (DUAL) {
        const int f2 = imax(cin2, ex2[k]) + p.ge2 * l + p.go2;
        if (hleft + gog2 >= f2) c |= TB_F2_OPEN;
        bool keep2;
        h = max_ge(h, f2, &keep2);
        if (!keep2) c = (c & ~TB_CHOICE) | TB_LEFT2;
      }
      const int j = i + d_lo + l;
      const bool jv = j >= 0 && j < tlen;
      H[k] = (jv || l == lb) ? h : NEG;
      if (!jv) {
        E[k] = NEG;
        E2[k] = NEG;
      }
      tbv[k] = c;
      if (p.row0 && l == l_row0) p.row0[(size_t)i * p.B + b] = H[k];
      if (!p.free_t_end && last && l == l_star) {
        best = H[k];
        best_j = tlen - 1;
      }
    }

    if (p.tb) {                      // one coalesced W-byte row per warp
      uint8_t* dst = p.tb + ((size_t)i * p.B + b) * W + L0;
      if (K >= 4) {
#pragma unroll
        for (int w4 = 0; w4 < K / 4; ++w4) {
          const uint32_t word = (uint32_t)tbv[4 * w4]
              | ((uint32_t)tbv[4 * w4 + 1] << 8)
              | ((uint32_t)tbv[4 * w4 + 2] << 16)
              | ((uint32_t)tbv[4 * w4 + 3] << 24);
          reinterpret_cast<uint32_t*>(dst)[w4] = word;
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) dst[k] = (uint8_t)tbv[k];
      }
    }

    if (p.free_t_end && last) {      // best H on the last row, first lane
      int bv = NEG, bl = -1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int l = L0 + k;
        const int j = i + d_lo + l;
        const int m = (j >= 0 && j < tlen) ? H[k] : NEG;
        if (bl < 0 || m > bv) {
          bv = m;
          bl = l;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(FULL, bv, off);
        const int ol = __shfl_xor_sync(FULL, bl, off);
        if (ov > bv || (ov == bv && ol < bl)) {
          bv = ov;
          bl = ol;
        }
      }
      if (nw > 1) {
        if (lane == 0) {
          xr[2 * wa] = bv;
          xr[2 * wa + 1] = bl;
        }
        __syncthreads();
        for (int w2 = 0; w2 < nw; ++w2) {
          const int ov = xr[2 * w2], ol = xr[2 * w2 + 1];
          if (ov > bv || (ov == bv && ol < bl)) {
            bv = ov;
            bl = ol;
          }
        }
      }
      best = bv;
      best_j = i + d_lo + bl;
    }
  }

  if (p.row0 && l_row0 >= L0 && l_row0 < L0 + K) {
    for (int i = rows; i < p.M; ++i) p.row0[(size_t)i * p.B + b] = NEG;
  }
  const bool writer = p.free_t_end ? (wa == 0 && lane == 0)
                                   : (l_star >= L0 && l_star < L0 + K);
  if (writer) {
    p.score[b] = best;
    p.end_j[b] = best_j;
  }
}

// Traceback walk, one thread per alignment, over the (M, B, W) traceback:
// the state machine of banded_align._walk_device, emitting the reverse-order
// op stream (0=M, 1=I, 2=D, 3=none) packed four 2-bit ops per byte into
// out[(n_steps/4, B)].
__global__ void walk_kernel(const uint8_t* tb, const int32_t* qlen,
                            const int32_t* tlen, int M, int B, int W,
                            int d_lo, int n_steps, uint8_t* out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = qlen[b] - 1, j = tlen[b] - 1, state = 0;
  bool done = i < 0 && j < 0;
  for (int s4 = 0; s4 < n_steps / 4; ++s4) {
    unsigned byte = 0;
    for (int r = 0; r < 4; ++r) {
      int op = 3;
      if (!done) {
        const int l = j - i - d_lo;
        int cell = TB_DIAG;
        if (l >= 0 && l < W && i >= 0 && j >= 0)
          cell = tb[((size_t)imin(i, M - 1) * B + b) * W + l];
        const int choice = cell & TB_CHOICE;
        if (i < 0) {
          op = 2; --j;
        } else if (j < 0) {
          op = 1; --i;
        } else if (state == 0) {
          if (choice == TB_DIAG) {
            op = 0; --i; --j;
          } else {
            state = choice == TB_UP ? 1 : choice == TB_UP2 ? 3
                  : choice == TB_LEFT ? 2 : 4;
          }
        } else if (state == 1 || state == 3) {
          op = 1; --i;
          if (cell & (state == 1 ? TB_E_OPEN : TB_E2_OPEN)) state = 0;
        } else {
          op = 2; --j;
          if (cell & (state == 2 ? TB_F_OPEN : TB_F2_OPEN)) state = 0;
        }
        done = i < 0 && j < 0;
      }
      byte |= (unsigned)op << (2 * r);
    }
    out[(size_t)s4 * B + b] = (uint8_t)byte;
  }
}

}  // namespace vsv
