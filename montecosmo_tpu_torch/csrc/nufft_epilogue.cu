// K3, the NUFFT epilogue: one fused pass over the rfft grid.  Forward, for
// the stacked rffts F_s (s = 0..S-1) of S interlaced paints:
//
//     out = sum_s F_s exp(i s/S (kx + ky + kz)) scale / (S W(k))
//
// Backward (torch's convention for complex tensors, grad = dL/d conj(z)):
//
//     dF_s = g exp(-i s/S (kx + ky + kz)) scale / (S W(k))
//
// W is the paint window's Fourier transform: the B-spline's prod_a
// sinc(k_a / 2 pi)^order or the Kaiser-Bessel window's (ops/fourier.py),
// a product of one factor per axis.  Replaces the phase sum of
// montecosmo_tpu/ops/paint.py::interlace (:192-195) and the units jacobian
// and window deconvolution of ::nufft (:233-237, via
// ops/fourier.py::window_hat), which XLA fused on the TPU.
//
// What bounds it on an H100: memory traffic, (S + 1) complex64 values an
// element and no reuse (at the 224^3 paint mesh of the 128^3 flagship,
// 2 x 45 MB in and 45 MB out: 0.0406 ms at 3.35 TB/s).  What the design
// does about it: nothing but the loads and stores is left per element.
// The window and the phase are separable, so the wrapper
// (ops/paint.py::_epilogue_tables) tabulates them once per geometry, on the
// device and by the plain version's own functions: the window's factor of
// each axis (X + Y + Z/2+1 values), and each axis's phase exp(i s k_a / S)
// for s >= 1.  A CTA covers one x-plane (blockIdx.y) and a run of y-rows,
// so no element index is divided; each thread forms its rows' x.y factors
// once and walks z along the threads, loading and storing float2 (8-byte)
// values with 32-bit indices.  W is formed as the plain version forms it,
// ((1 wx) wy) wz in float32, and the constant is divided by it with an IEEE
// division: at the flagship's Kaiser-Bessel cutoff W crosses zero inside
// the grid, where 1/W amplifies any difference in W.  The s = 0 phase is 1
// and is skipped.
//
// Plain C interface, loaded with ctypes, as paint_cic.cu; the entry point
// returns cudaGetLastError() (cudaErrorInvalidValue for S outside 1-8).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Per-axis tables: the window's factor of each axis (unread without a
// deconvolution) and the phases exp(i s k / S), s = 1..S-1, row s - 1.
struct Tables {
  const float* wx;
  const float* wy;
  const float* wz;
  const float2* px;
  const float2* py;
  const float2* pz;
};

template <int S, bool kBackward, bool kDeconv>
__global__ void __launch_bounds__(kThreads)
    nufft_epilogue_kernel(const float2* __restrict__ src, float2* __restrict__ dst, int Y,
                          int ZC, int M, float c0, Tables t) {
  const int X = gridDim.y, ix = blockIdx.y;
  const int rows = blockDim.y * kRowsPerThread;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int iy = blockIdx.x * rows + j * blockDim.y + threadIdx.y;
    if (iy >= Y) return;
    const int row = (ix * Y + iy) * ZC;
    const float wxy = kDeconv ? (1.f * __ldg(t.wx + ix)) * __ldg(t.wy + iy) : 1.f;
    float2 pxy[S > 1 ? S - 1 : 1];
#pragma unroll
    for (int s = 1; s < S; ++s)
      pxy[s - 1] = cmul(t.px[(s - 1) * X + ix], t.py[(s - 1) * Y + iy]);
    for (int z = threadIdx.x; z < ZC; z += blockDim.x) {
      const int e = row + z;
      const float c = kDeconv ? __fdiv_rn(c0, wxy * __ldg(t.wz + z)) : c0;
      if (kBackward) {
        const float2 g = src[e];
        dst[e] = make_float2(g.x * c, g.y * c);
#pragma unroll
        for (int s = 1; s < S; ++s) {
          const float2 p = cmul(pxy[s - 1], t.pz[(s - 1) * ZC + z]);
          const float2 f = make_float2(p.x * c, -(p.y * c));
          dst[s * M + e] = cmul(g, f);
        }
      } else {
        const float2 f0 = src[e];
        float2 acc = make_float2(f0.x * c, f0.y * c);
#pragma unroll
        for (int s = 1; s < S; ++s) {
          const float2 p = cmul(pxy[s - 1], t.pz[(s - 1) * ZC + z]);
          const float2 v = cmul(src[s * M + e], make_float2(p.x * c, p.y * c));
          acc.x += v.x;
          acc.y += v.y;
        }
        dst[e] = acc;
      }
    }
  }
}

template <int S>
void launch(const float2* src, float2* dst, int X, int Y, int ZC, float c0, int deconv,
            int backward, const Tables& t, dim3 block, cudaStream_t stream) {
  const int rows = block.y * kRowsPerThread;
  const dim3 grid((Y + rows - 1) / rows, X);
  const int M = X * Y * ZC;
  if (backward) {
    if (deconv)
      nufft_epilogue_kernel<S, true, true><<<grid, block, 0, stream>>>(src, dst, Y, ZC, M, c0, t);
    else
      nufft_epilogue_kernel<S, true, false><<<grid, block, 0, stream>>>(src, dst, Y, ZC, M, c0, t);
  } else {
    if (deconv)
      nufft_epilogue_kernel<S, false, true><<<grid, block, 0, stream>>>(src, dst, Y, ZC, M, c0, t);
    else
      nufft_epilogue_kernel<S, false, false><<<grid, block, 0, stream>>>(src, dst, Y, ZC, M, c0,
                                                                         t);
  }
}

}  // namespace

// src, dst: complex64 as float2, (S, X, Y, ZC) and (X, Y, ZC) (forward) or
// the other way round (backward); c0 = scale / S in float32; wx, wy, wz the
// window's factors (ignored unless deconv), px, py, pz the phase tables
// ((S - 1, X), (S - 1, Y), (S - 1, ZC) float2).  S X Y ZC < 2^31 (the
// wrapper checks it).
extern "C" int nufft_epilogue(const void* src, void* dst, int S, int X, int Y, int ZC, float c0,
                              int deconv, int backward, const float* wx, const float* wy,
                              const float* wz, const void* px, const void* py, const void* pz,
                              void* stream) {
  const Tables t{wx, wy, wz, static_cast<const float2*>(px), static_cast<const float2*>(py),
                 static_cast<const float2*>(pz)};
  // z along the threads (a warp multiple, at most 128), rows along y
  const int bx = ZC >= 128 ? 128 : ((ZC + 31) / 32) * 32;
  const dim3 block(bx, kThreads / bx);
  const auto* in = static_cast<const float2*>(src);
  auto* out = static_cast<float2*>(dst);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: launch<1>(in, out, X, Y, ZC, c0, deconv, backward, t, block, s); break;
    case 2: launch<2>(in, out, X, Y, ZC, c0, deconv, backward, t, block, s); break;
    case 3: launch<3>(in, out, X, Y, ZC, c0, deconv, backward, t, block, s); break;
    case 4: launch<4>(in, out, X, Y, ZC, c0, deconv, backward, t, block, s); break;
    case 5: launch<5>(in, out, X, Y, ZC, c0, deconv, backward, t, block, s); break;
    case 6: launch<6>(in, out, X, Y, ZC, c0, deconv, backward, t, block, s); break;
    case 7: launch<7>(in, out, X, Y, ZC, c0, deconv, backward, t, block, s); break;
    case 8: launch<8>(in, out, X, Y, ZC, c0, deconv, backward, t, block, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
