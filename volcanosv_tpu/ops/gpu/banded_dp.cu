// XLA FFI handlers for the banded DP and traceback walk (banded_dp.cuh).
// Each handler only checks shapes and enqueues one kernel on XLA's stream.
#include <string>

#include <cuda_runtime.h>

#include "banded_dp.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

template <bool DUAL>
void launch_dp(const vsv::DpParams& p, const vsv::DpLaunch& s,
               cudaStream_t stream) {
  const size_t smem = vsv::SMEM_INTS * sizeof(int);
  switch (s.K) {
    case 1:
      vsv::banded_dp_kernel<1, DUAL><<<s.grid, s.threads, smem, stream>>>(p);
      break;
    case 2:
      vsv::banded_dp_kernel<2, DUAL><<<s.grid, s.threads, smem, stream>>>(p);
      break;
    case 4:
      vsv::banded_dp_kernel<4, DUAL><<<s.grid, s.threads, smem, stream>>>(p);
      break;
    default:
      vsv::banded_dp_kernel<8, DUAL><<<s.grid, s.threads, smem, stream>>>(p);
  }
}

ffi::Error launched(const char* what) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string(what) + ": " +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error BandedDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> q,
                        ffi::Buffer<ffi::S8> t, ffi::Buffer<ffi::S32> qlen,
                        ffi::Buffer<ffi::S32> tlen,
                        ffi::ResultBuffer<ffi::S32> score,
                        ffi::ResultBuffer<ffi::S32> end_j,
                        ffi::ResultBuffer<ffi::U8> tb,
                        ffi::ResultBuffer<ffi::S32> row0, int32_t W,
                        int32_t d_lo, int32_t match, int32_t mismatch,
                        int32_t go, int32_t ge, int32_t go2, int32_t ge2,
                        int32_t dual, int32_t free_t_end) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  if (qd.size() != 2 || td.size() != 2 || td[0] != qd[0])
    return ffi::Error::InvalidArgument("q must be (B, M) and t (B, N)");
  vsv::DpLaunch shape;
  if (!vsv::dp_launch(W, static_cast<int>(qd[0]), &shape) || d_lo > 0 ||
      -d_lo >= W)
    return ffi::Error::InvalidArgument(
        "W must be 32, 64, 128 or a multiple of 256 up to 4096, "
        "with -W < d_lo <= 0");
  vsv::DpParams p;
  p.B = static_cast<int>(qd[0]);
  p.M = static_cast<int>(qd[1]);
  p.N = static_cast<int>(td[1]);
  p.W = W;
  p.d_lo = d_lo;
  p.match = match;
  p.mismatch = mismatch;
  p.go = go;
  p.ge = ge;
  p.go2 = go2;
  p.ge2 = ge2;
  p.free_t_end = free_t_end;
  p.q = q.typed_data();
  p.t = t.typed_data();
  p.qlen = qlen.typed_data();
  p.tlen = tlen.typed_data();
  p.score = score->typed_data();
  p.end_j = end_j->typed_data();
  p.tb = tb->element_count() ? tb->typed_data() : nullptr;
  p.row0 = row0->element_count() ? row0->typed_data() : nullptr;
  if (p.B == 0) return ffi::Error::Success();
  if (dual)
    launch_dp<true>(p, shape, stream);
  else
    launch_dp<false>(p, shape, stream);
  return launched("banded_dp_kernel");
}

ffi::Error WalkImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> tb,
                    ffi::Buffer<ffi::S32> qlen, ffi::Buffer<ffi::S32> tlen,
                    ffi::ResultBuffer<ffi::U8> out, int32_t d_lo) {
  const auto d = tb.dimensions();
  const auto od = out->dimensions();
  if (d.size() != 3 || od.size() != 2 || od[1] != d[1])
    return ffi::Error::InvalidArgument(
        "tb must be (M, B, W) and the op stream (n_steps / 4, B)");
  const int M = static_cast<int>(d[0]), B = static_cast<int>(d[1]);
  const int W = static_cast<int>(d[2]);
  const int n_steps = 4 * static_cast<int>(od[0]);
  if (B == 0) return ffi::Error::Success();
  const int threads = 64;
  vsv::walk_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      tb.typed_data(), qlen.typed_data(), tlen.typed_data(), M, B, W, d_lo,
      n_steps, out->typed_data());
  return launched("walk_kernel");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    VsvBandedDp, BandedDpImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S8>>()      // q
        .Arg<ffi::Buffer<ffi::S8>>()      // t
        .Arg<ffi::Buffer<ffi::S32>>()     // qlen
        .Arg<ffi::Buffer<ffi::S32>>()     // tlen
        .Ret<ffi::Buffer<ffi::S32>>()     // score
        .Ret<ffi::Buffer<ffi::S32>>()     // end_j
        .Ret<ffi::Buffer<ffi::U8>>()      // tb, (M, B, W) or (0,)
        .Ret<ffi::Buffer<ffi::S32>>()     // row0, (M, B) or (0,)
        .Attr<int32_t>("W")
        .Attr<int32_t>("d_lo")
        .Attr<int32_t>("match")
        .Attr<int32_t>("mismatch")
        .Attr<int32_t>("go")
        .Attr<int32_t>("ge")
        .Attr<int32_t>("go2")
        .Attr<int32_t>("ge2")
        .Attr<int32_t>("dual")
        .Attr<int32_t>("free_t_end"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    VsvWalk, WalkImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()      // tb (M, B, W)
        .Arg<ffi::Buffer<ffi::S32>>()     // qlen
        .Arg<ffi::Buffer<ffi::S32>>()     // tlen
        .Ret<ffi::Buffer<ffi::U8>>()      // packed ops (n_steps / 4, B)
        .Attr<int32_t>("d_lo"));
