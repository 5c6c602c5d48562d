// Host build of the Hopper banded-DP kernels (volcanosv_tpu/ops/gpu/
// banded_dp.cuh) under a small warp emulator, so the CPU tests can hold the
// CUDA source itself to banded_align_scan's results.  Every CUDA thread of a
// block is a std::thread; warp shuffles and __syncthreads are barriers.
// Blocks run one after another.  DPX intrinsics take their portable
// fallback here (the header selects them only when compiling for sm_90).
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

struct Dim3 {
  unsigned x = 0, y = 0, z = 0;
};

namespace {
thread_local Dim3 tl_thread, tl_block_idx;
Dim3 g_block_dim;

struct Warp {
  std::barrier<>* bar;
  int buf[32];
};
thread_local Warp* tl_warp = nullptr;
thread_local std::barrier<>* tl_block = nullptr;

int exchange(int v, int src) {
  Warp* w = tl_warp;
  const int lane = tl_thread.x & 31;
  w->buf[lane] = v;
  w->bar->arrive_and_wait();
  const int r = (src >= 0 && src < 32) ? w->buf[src] : v;
  w->bar->arrive_and_wait();
  return r;
}
}  // namespace

#define threadIdx tl_thread
#define blockIdx tl_block_idx
#define blockDim g_block_dim
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __shared__

int __shfl_down_sync(unsigned, int v, int d) {
  return exchange(v, (int)(tl_thread.x & 31) + d);
}
int __shfl_up_sync(unsigned, int v, int d) {
  return exchange(v, (int)(tl_thread.x & 31) - d);
}
int __shfl_xor_sync(unsigned, int v, int m) {
  return exchange(v, (int)(tl_thread.x & 31) ^ m);
}
void __syncthreads() { tl_block->arrive_and_wait(); }

#include "banded_dp.cuh"

namespace vsv {
int smem[SMEM_INTS];
}

template <class F>
static void launch(int grid, int threads, F body) {
  g_block_dim.x = threads;
  for (int bi = 0; bi < grid; ++bi) {
    const int n_warps = (threads + 31) / 32;
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<Warp> warps(n_warps);
    for (int w = 0; w < n_warps; ++w) {
      bars.emplace_back(new std::barrier<>(32));
      warps[w].bar = bars.back().get();
    }
    std::barrier<> block_bar(threads);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, t] {
        tl_thread.x = t;
        tl_block_idx.x = bi;
        tl_warp = &warps[t / 32];
        tl_block = &block_bar;
        body();
      });
    }
    for (auto& th : pool) th.join();
  }
}

extern "C" int emu_banded_dp(const int8_t* q, const int8_t* t,
                             const int32_t* qlen, const int32_t* tlen, int B,
                             int M, int N, int W, int d_lo, int match,
                             int mismatch, int go, int ge, int go2, int ge2,
                             int dual, int free_t_end, int32_t* score,
                             int32_t* end_j, uint8_t* tb, int32_t* row0) {
  vsv::DpLaunch s;
  if (!vsv::dp_launch(W, B, &s)) return 1;
  vsv::DpParams p{B, M, N, W, d_lo, match, mismatch, go, ge, go2, ge2,
                  free_t_end, q, t, qlen, tlen, score, end_j, tb, row0};
  auto run = [&](auto kernel) { launch(s.grid, s.threads, [&] { kernel(p); }); };
  if (dual) {
    switch (s.K) {
      case 1: run(vsv::banded_dp_kernel<1, true>); break;
      case 2: run(vsv::banded_dp_kernel<2, true>); break;
      case 4: run(vsv::banded_dp_kernel<4, true>); break;
      default: run(vsv::banded_dp_kernel<8, true>);
    }
  } else {
    switch (s.K) {
      case 1: run(vsv::banded_dp_kernel<1, false>); break;
      case 2: run(vsv::banded_dp_kernel<2, false>); break;
      case 4: run(vsv::banded_dp_kernel<4, false>); break;
      default: run(vsv::banded_dp_kernel<8, false>);
    }
  }
  return 0;
}

extern "C" void emu_walk(const uint8_t* tb, const int32_t* qlen,
                         const int32_t* tlen, int M, int B, int W, int d_lo,
                         int n_steps, uint8_t* out) {
  const int threads = 64;
  launch((B + threads - 1) / threads, threads, [&] {
    vsv::walk_kernel(tb, qlen, tlen, M, B, W, d_lo, n_steps, out);
  });
}
