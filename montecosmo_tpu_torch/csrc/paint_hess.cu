// The double backward of the paint (K1 -> K2) and of the read (K4 -> K5):
// K6, the paint of the window and its gradient, and K7, the read of the
// window's gradient and Hessian.  Windows, clamp and geometry are shared
// with the other particle kernels (paint_window.cuh).
//
// Replaces the second derivatives that XLA's autodiff takes of
// montecosmo_tpu/ops/paint_window.py::paint_window (:240) and ::read_window
// (:330), and of ops/paint.py::paint / read / read_multi, when a
// Hessian-vector product (the Laplace mass seed, lapprox) differentiates
// their VJPs once more.  The JAX package has no kernel for it: XLA
// re-linearises its one-hot window matmuls.
//
// Math, per particle p at (clamped) position x_p and interlace shift s, the
// window W = w_x w_y w_z of paint_window.cuh, its gradient grad W and its
// Hessian H_W, each derivative zero along an axis where the clamp is
// active (|pos - site| >= H: K2's rule):
//   K6: out_s[c, ch] += alpha[p, ch] W(x_ps - c) + beta[p, ch, :] . grad W(x_ps - c)
//       (alpha may be absent: 0).  It is K2's backward with respect to the
//       cotangent meshes (alpha = a, beta = w b for cotangents a on dw and b
//       on dpos), and K5's with respect to the mesh (beta = r (x) b).
//   K7: g[p, ch, :] = sum_s sum_c M_s[c, ch] grad W(x_ps - c),
//       h[p, ch, :] = sum_s sum_c M_s[c, ch] H_W(x_ps - c) b[p, :].
//       K2's backward with respect to the positions (a g + w h, M = the
//       cotangent meshes) and the weights (b . g), and K5's with respect to
//       the positions and the cotangent.
// Meshes are channel-last, (S, X, Y, Z, C) with C <= kMaxC (the wrapper
// launches once per 4 channels of a wider one).
//
// What bounds them on an H100: at the 224^3 render (11.24M particles, two
// shifts, CIC, C = 1) K6 moves 315 MB of positions and per-particle vectors
// and 90 MB of meshes, >= 0.12 ms at 3.35 TB/s, but this design makes
// P^3 S C atomics a particle (180M at CIC) as K1's atomic design does, so
// it is bound by the L2 atomic rate; K7 reads 270 MB of positions
// and b, 90 MB of meshes and writes 270 MB of g and h (>= 0.19 ms), as
// local a gather as K2's, and its least arithmetic (three z-sums a corner
// and channel) bounds it at PCS.
//
// The designs here are one thread per particle in lattice order (a warp's
// corners share L2 lines), the P per-axis weights, derivatives and second
// derivatives computed once per particle and shift, the clamped axes'
// derivatives zeroed there.  K6 (atomic) adds each corner's value to
// device memory, as a 64-bit fixed-point integer into K1's accumulator
// (mesh_fixed.cuh: a max pass over |alpha| + |beta| first, a conversion
// pass after), so that its meshes, and a Hessian-vector product, are the
// same bit for bit from launch to launch; K7 (gather) reads the corners from device memory and
// keeps its 6 C sums in registers, factored per (i, j) (hess_corners,
// paint_window.cuh: three FMAs a corner and channel, not the nine
// products of H_W b), and writes them once (more than one channel staged
// through shared memory so that a block's stores are contiguous,
// `store_staged`).  The lattice-brick designs,
// the route's from the order ops/paint.py::TILED_FROM names, sum K6's
// corners in a fixed-point shared-memory tile (paint_tiled.cu) and stage
// K7's boxes of the meshes in shared memory (read_tiled.cu).
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() of its launch (cudaErrorInvalidValue for an order
// outside 1-4, a channel count outside 1-4, or K7 at a Kaiser-Bessel
// window, whose second derivative is not ported).
#include "mesh_fixed.cuh"
#include "paint_window.cuh"

namespace {

// The windows of particle p at shift sh, the derivatives of a clamped axis
// zeroed.
template <class W>
__device__ __forceinline__ void windows(const float* __restrict__ pos, int64_t p, const Site& q,
                                        const Geom& g, float sh, Win<W::P>& wx, Win<W::P>& wy,
                                        Win<W::P>& wz) {
  constexpr int P = W::P;
  float x, y, z;
  const bool ax = place(pos[3 * p] + sh, q.qx, g.Hx, g.clamp, x);
  const bool ay = place(pos[3 * p + 1] + sh, q.qy, g.Hy, g.clamp, y);
  const bool az = place(pos[3 * p + 2] + sh, q.qz, g.Hz, g.clamp, z);
  W::eval(x, g.X, q.bx, g, wx);
  W::eval(y, g.Y, q.by, g, wy);
  W::eval(z, g.Z, q.bz, g, wz);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!ax) wx.d[k] = wx.d2[k] = 0.f;
    if (!ay) wy.d[k] = wy.d2[k] = 0.f;
    if (!az) wz.d[k] = wz.d2[k] = 0.f;
  }
}

template <class W>
__global__ void paint_cic_grad_kernel(const float* __restrict__ pos,
                                      const float* __restrict__ alpha,
                                      const float* __restrict__ beta, int64_t n_p, int C, Geom g,
                                      float* __restrict__ out, unsigned long long* acc,
                                      const unsigned* vmax) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_p) return;
  constexpr int P = W::P;
  const Site q = site<P>(p, g);
  const int64_t N = (int64_t)g.X * g.Y * g.Z;
  const MeshSum ms = mesh_sum(acc, vmax, n_p);
  float a[kMaxC], bx[kMaxC], by[kMaxC], bz[kMaxC];
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch) {
    const bool on = ch < C;
    a[ch] = on && alpha ? alpha[p * C + ch] : 0.f;
    bx[ch] = on ? beta[(p * C + ch) * 3] : 0.f;
    by[ch] = on ? beta[(p * C + ch) * 3 + 1] : 0.f;
    bz[ch] = on ? beta[(p * C + ch) * 3 + 2] : 0.f;
  }
  for (int s = 0; s < g.n_shift; ++s) {
    Win<P> wx, wy, wz;
    windows<W>(pos, p, q, g, (float)s / (float)g.n_shift, wx, wy, wz);
    const int64_t o = (int64_t)s * N * C;
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int64_t row = ((int64_t)wx.i[i] * g.Y + wy.i[j]) * g.Z;
        const float wxy = wx.w[i] * wy.w[j], dxy = wx.d[i] * wy.w[j], xdy = wx.w[i] * wy.d[j];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float wt = wxy * wz.w[k], gx = dxy * wz.w[k], gy = xdy * wz.w[k],
                      gz = wxy * wz.d[k];
          const int64_t cell = o + (row + wz.i[k]) * C;
#pragma unroll
          for (int ch = 0; ch < kMaxC; ++ch)
            if (ch < C)
              ms.add(out, cell + ch, a[ch] * wt + bx[ch] * gx + by[ch] * gy + bz[ch] * gz);
        }
      }
  }
}

constexpr int kThreads = 256;

// Writes each thread's n floats v (the block's particles' outputs, n a
// particle) to out, staged in shared memory so that the block's stores are
// contiguous: a thread's own n floats lie n apart from its neighbour's, so
// direct stores touch a sector a float (at C = 3, 9 floats a thread, they
// made K7 3.0-4.4x slower at CIC and NGP: chip_smoke.py 3c, PERF.md).
// Every thread of the block calls it.
template <int n>
__device__ __forceinline__ void store_staged(float* stage, const float (&v)[n], int64_t first,
                                             int64_t n_p, float* __restrict__ out) {
#pragma unroll
  for (int k = 0; k < n; ++k) stage[threadIdx.x * n + k] = v[k];
  __syncthreads();
  const int count = (int)min((int64_t)blockDim.x, n_p - first) * n;
  for (int i = threadIdx.x; i < count; i += blockDim.x) out[first * n + i] = stage[i];
  __syncthreads();
}

template <class W, int C>
__global__ void __launch_bounds__(kThreads)
    read_cic_hess_kernel(const float* __restrict__ pos, const float* __restrict__ mesh,
                         const float* __restrict__ b, int64_t n_p, Geom g,
                         float* __restrict__ gout, float* __restrict__ hout) {
  __shared__ float stage[kThreads * 3 * C];
  const int64_t first = (int64_t)blockIdx.x * blockDim.x, p = first + threadIdx.x;
  constexpr int P = W::P;
  float gs[C][3] = {}, hs[C][3] = {};
  if (p < n_p) {
    const Site q = site<P>(p, g);
    const int64_t N = (int64_t)g.X * g.Y * g.Z;
    const float bv[3] = {b[3 * p], b[3 * p + 1], b[3 * p + 2]};
    for (int s = 0; s < g.n_shift; ++s) {
      Win<P> wx, wy, wz;
      windows<W>(pos, p, q, g, (float)s / (float)g.n_shift, wx, wy, wz);
      const MeshCells<C, P> cells{mesh + (int64_t)s * N * C, g, wx, wy, wz};
      hess_corners<C>(cells, wx, wy, wz, bv, gs, hs);
    }
  }
  if constexpr (C == 1) {  // 3 floats a thread, 12 bytes apart: near contiguous
    if (p < n_p)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gout[3 * p + a] = gs[0][a];
        hout[3 * p + a] = hs[0][a];
      }
  } else {
    store_staged(stage, reinterpret_cast<const float(&)[3 * C]>(gs), first, n_p, gout);
    store_staged(stage, reinterpret_cast<const float(&)[3 * C]>(hs), first, n_p, hout);
  }
}


unsigned blocks_for(long long n_p) { return (unsigned)((n_p + kThreads - 1) / kThreads); }

}  // namespace

// acc: the fixed-point accumulator (mesh_fixed.cuh), n_shift X Y Z C + 1
// int64 words; null: float atomics, in a run-dependent order.
extern "C" int paint_cic_grad(const float* pos, const float* alpha, const float* beta_p,
                              long long n_p, int C, GEOM_PARAMS, float* out,
                              unsigned long long* acc, void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(GEOM_ARGS);
  const long long cells = (long long)n_shift * X * Y * Z * C;
  const cudaStream_t s = (cudaStream_t)stream;
  if (acc != nullptr && n_p > 0) mesh_sum_begin_grad(acc, cells, alpha, beta_p, n_p * C, s);
  const unsigned* vmax = acc ? (const unsigned*)(acc + cells) : nullptr;
  DISPATCH_WINDOW(order, kb, paint_cic_grad_kernel<W><<<blocks_for(n_p), kThreads, 0, s>>>(
                                 pos, alpha, beta_p, n_p, C, g, out, acc, vmax));
  if (acc != nullptr && n_p > 0) mesh_sum_end(acc, cells, n_p, out, s);
  return (int)cudaGetLastError();
}

template <class W>
int read_hess(int C, const Geom& g, long long n_p, void* stream, const float* pos,
              const float* mesh, const float* b, float* gout, float* hout) {
  const unsigned nb = blocks_for(n_p);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      read_cic_hess_kernel<W, 1><<<nb, kThreads, 0, st>>>(pos, mesh, b, n_p, g, gout, hout);
      break;
    case 2:
      read_cic_hess_kernel<W, 2><<<nb, kThreads, 0, st>>>(pos, mesh, b, n_p, g, gout, hout);
      break;
    case 3:
      read_cic_hess_kernel<W, 3><<<nb, kThreads, 0, st>>>(pos, mesh, b, n_p, g, gout, hout);
      break;
    case 4:
      read_cic_hess_kernel<W, 4><<<nb, kThreads, 0, st>>>(pos, mesh, b, n_p, g, gout, hout);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int read_cic_hess(const float* pos, const float* mesh, const float* b, long long n_p,
                             int C, GEOM_PARAMS, float* gout, float* hout, void* stream) {
  if (C < 1 || C > kMaxC || kb) return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(GEOM_ARGS);
  int code = (int)cudaSuccess;
  DISPATCH_BSPLINE(order, code = read_hess<W>(C, g, n_p, stream, pos, mesh, b, gout, hout));
  return code;
}
