// Interlaced paint (K1) and its adjoint (K2) for lattice-ordered particles;
// the C-channel read (K4) and its adjoint (K5): one thread per particle,
// every corner product sent to device memory with an atomic add.  These
// are the kernels of the unclamped scatter (no lattice) and of K2/K4;
// the clamped (lattice) K1 and K5 are the lattice-brick kernels of
// paint_tiled.cu.  The windows, the clamp and the geometry are shared, in
// paint_window.cuh; the file and kernel names come from the CIC (order-2)
// version.
//
// Replaces, on the model's main path, the XLA window paint
// montecosmo_tpu/ops/paint_window.py::paint_window (with _clip_to_sites and
// the interlace loop of montecosmo_tpu/ops/paint.py::interlace), and the two
// Pallas kernels the JAX package once had for the same math
// (ops/paint_pallas.py::paint_pallas_cic, and
// ops/paint_window_pallas.py::_paint_group_kernel / _paint_group_bwd_kernel
// with the windows _bspline_T / _dbspline_T, orders 1-4).
//
// What bounds it on an H100: K1 here is P^3 n float atomics per particle
// (11.24M particles x 2 shifts: 22M at NGP, 180M at CIC, 607M at TSC,
// 1.44G at PCS) into a 45 MB mesh per shift, i.e. the L2 atomic throughput.
// The TPU kernels built per-group one-hot windows for the MXU because
// scatters are slow there; on Hopper the atomic scatter is the natural
// form.  Design: one thread per particle, particles in lattice order so a
// warp's 32 particles share most of their corner cells and their atomics
// land in the same few L2 lines; both interlace shifts are painted in one
// pass over the particle array (positions and weights are read once); the
// P per-axis weights are computed once per particle and shift, then the P^3
// corners are looped over.
//
// K2 gathers the P^3 corners of every shift from the cotangent meshes: it
// writes dweights (the weighted read) and dpos (the read of the derivative
// window, times the weight), zeroed on the axes where the clamp was active.
// No atomics; bounded by the scattered 4-byte reads (P^3 n per particle),
// which are as local as K1's writes.  Its own backward (the double
// backward) is K6 and K7 of paint_hess.cu.
//
// K4 reads C <= 4 fields of a channel-last (X, Y, Z, C) mesh (the wrapper
// launches once per 4 channels of a wider one) at the same
// (clamped) positions: the N-body force read.  It replaces
// montecosmo_tpu/ops/paint_window.py::read_window (clip=True, as
// ops/pm.py::pm_forces calls it from every BullFrog step) and
// ops/paint.py::read / read_multi (no lattice, no clamp).  The TPU formulation
// contracted one-hot windows against a wrap-padded mesh on the MXU to avoid
// gathers; on Hopper a gather is cheap when it is local.  Bound: at 224^3 and
// C = 3 it reads 135 MB of positions and at least 135 MB of mesh and writes
// 135 MB of values, >= 0.12 ms at 3.35 TB/s.  Design: one thread per
// particle in lattice order, so a warp's corners share L2 lines; each corner
// is C contiguous floats; no atomics.
//
// K5 is K4's VJP in one particle pass: the C-channel paint of the cotangent
// into dmesh (P^3 C float atomics per particle: 270M at 224^3 with C = 3 at
// CIC, 910M at TSC, so it is bound by the L2 atomic rate as K1 is) and the
// position gradient from the derivative window, zeroed on clamped axes
// (K2's rule).  The lattice-brick K5 of paint_tiled.cu folds its tile
// with sm_90's vector atomicAdd on float2/float4 where C allows.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() of its launch (cudaErrorInvalidValue for an order
// outside 1-4, or for K4/K5 a channel count outside 1-4).  The window is
// chosen at run time among the 8 instantiations of each kernel.
#include "paint_window.cuh"

namespace {

template <class W>
__global__ void paint_cic_forward_kernel(const float* __restrict__ pos,
                                         const float* __restrict__ w, int64_t n_p, Geom g,
                                         float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_p) return;
  constexpr int P = W::P;
  const float px = pos[3 * p], py = pos[3 * p + 1], pz = pos[3 * p + 2];
  const float wp = w[p];
  const Site q = site<P>(p, g);
  const int64_t N = (int64_t)g.X * g.Y * g.Z;

  for (int s = 0; s < g.n_shift; ++s) {
    const float sh = (float)s / (float)g.n_shift;
    float x, y, z;
    place(px + sh, q.qx, g.Hx, g.clamp, x);
    place(py + sh, q.qy, g.Hy, g.clamp, y);
    place(pz + sh, q.qz, g.Hz, g.clamp, z);
    Win<P> wx, wy, wz;
    W::eval(x, g.X, q.bx, g, wx);
    W::eval(y, g.Y, q.by, g, wy);
    W::eval(z, g.Z, q.bz, g, wz);
    float* o = out + (int64_t)s * N;
#pragma unroll
    for (int a = 0; a < P; ++a)
#pragma unroll
      for (int b = 0; b < P; ++b) {
        const int64_t row = ((int64_t)wx.i[a] * g.Y + wy.i[b]) * g.Z;
        const float wab = wp * (wx.w[a] * wy.w[b]);
#pragma unroll
        for (int c = 0; c < P; ++c) atomicAdd(o + row + wz.i[c], wab * wz.w[c]);
      }
  }
}

template <class W>
__global__ void paint_cic_adjoint_kernel(const float* __restrict__ pos,
                                         const float* __restrict__ w,
                                         const float* __restrict__ grad, int64_t n_p, Geom g,
                                         float* __restrict__ dpos, float* __restrict__ dw) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_p) return;
  constexpr int P = W::P;
  const float px = pos[3 * p], py = pos[3 * p + 1], pz = pos[3 * p + 2];
  const Site q = site<P>(p, g);
  const int64_t N = (int64_t)g.X * g.Y * g.Z;

  float acc_w = 0.f, acc_x = 0.f, acc_y = 0.f, acc_z = 0.f;
  for (int s = 0; s < g.n_shift; ++s) {
    const float sh = (float)s / (float)g.n_shift;
    float x, y, z;
    const bool ax = place(px + sh, q.qx, g.Hx, g.clamp, x);
    const bool ay = place(py + sh, q.qy, g.Hy, g.clamp, y);
    const bool az = place(pz + sh, q.qz, g.Hz, g.clamp, z);
    Win<P> wx, wy, wz;
    W::eval(x, g.X, q.bx, g, wx);
    W::eval(y, g.Y, q.by, g, wy);
    W::eval(z, g.Z, q.bz, g, wz);
    const float* gs = grad + (int64_t)s * N;
    float sw = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int a = 0; a < P; ++a)
#pragma unroll
      for (int b = 0; b < P; ++b) {
        const int64_t row = ((int64_t)wx.i[a] * g.Y + wy.i[b]) * g.Z;
        const float wxy = wx.w[a] * wy.w[b], dxy = wx.d[a] * wy.w[b],
                    xdy = wx.w[a] * wy.d[b];
#pragma unroll
        for (int c = 0; c < P; ++c) {
          const float v = __ldg(gs + row + wz.i[c]);
          sw += v * (wxy * wz.w[c]);
          sx += v * (dxy * wz.w[c]);
          sy += v * (xdy * wz.w[c]);
          sz += v * (wxy * wz.d[c]);
        }
      }
    acc_w += sw;
    if (ax) acc_x += sx;
    if (ay) acc_y += sy;
    if (az) acc_z += sz;
  }
  const float wp = w[p];
  dw[p] = acc_w;
  dpos[3 * p] = wp * acc_x;
  dpos[3 * p + 1] = wp * acc_y;
  dpos[3 * p + 2] = wp * acc_z;
}

// K4: vals[p, c] = sum over the P^3 corners of W(corner - x_p) mesh[corner, c],
// x_p the (clamped) position; the mesh is channel-last (X, Y, Z, C), C <= kMaxC.
// The corners are unrolled around the channel loop: a corner's C floats are
// one contiguous load, and no runtime loop encloses the P^3 corner addresses
// (hoisted out of a channel loop, 64 of them took all 255 registers at PCS).
template <class W>
__global__ void read_cic_forward_kernel(const float* __restrict__ pos,
                                        const float* __restrict__ mesh, int64_t n_p, int C,
                                        Geom g, float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_p) return;
  constexpr int P = W::P;
  const Site q = site<P>(p, g);
  float x, y, z;
  place(pos[3 * p], q.qx, g.Hx, g.clamp, x);
  place(pos[3 * p + 1], q.qy, g.Hy, g.clamp, y);
  place(pos[3 * p + 2], q.qz, g.Hz, g.clamp, z);
  Win<P> wx, wy, wz;
  W::eval(x, g.X, q.bx, g, wx);
  W::eval(y, g.Y, q.by, g, wy);
  W::eval(z, g.Z, q.bz, g, wz);
  float acc[kMaxC] = {};
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const int64_t row = ((int64_t)wx.i[a] * g.Y + wy.i[b]) * g.Z;
      const float wxy = wx.w[a] * wy.w[b];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float wt = wxy * wz.w[c];
        const float* m = mesh + (row + wz.i[c]) * C;
#pragma unroll
        for (int ch = 0; ch < kMaxC; ++ch)
          if (ch < C) acc[ch] += wt * __ldg(m + ch);
      }
    }
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch)
    if (ch < C) out[p * C + ch] = acc[ch];
}

// K5: the VJP of K4 for a cotangent ct (P, C).  dmesh (zeroed by the caller)
// gets the C-channel paint of ct (atomics); dpos gets
// sum_c ct[p, c] sum_corners grad W . mesh[corner, c], zero on the axes where
// the clamp was active (K2's rule, strict |d| < H).  Loops as K4's.
template <class W>
__global__ void read_cic_adjoint_kernel(const float* __restrict__ pos,
                                        const float* __restrict__ mesh,
                                        const float* __restrict__ ct, int64_t n_p, int C,
                                        Geom g, float* __restrict__ dmesh,
                                        float* __restrict__ dpos) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_p) return;
  constexpr int P = W::P;
  const Site q = site<P>(p, g);
  float x, y, z;
  const bool ax = place(pos[3 * p], q.qx, g.Hx, g.clamp, x);
  const bool ay = place(pos[3 * p + 1], q.qy, g.Hy, g.clamp, y);
  const bool az = place(pos[3 * p + 2], q.qz, g.Hz, g.clamp, z);
  Win<P> wx, wy, wz;
  W::eval(x, g.X, q.bx, g, wx);
  W::eval(y, g.Y, q.by, g, wy);
  W::eval(z, g.Z, q.bz, g, wz);
  float t[kMaxC];
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch) t[ch] = ch < C ? ct[p * C + ch] : 0.f;
  float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const int64_t row = ((int64_t)wx.i[a] * g.Y + wy.i[b]) * g.Z;
      const float wxy = wx.w[a] * wy.w[b], dxy = wx.d[a] * wy.w[b],
                  xdy = wx.w[a] * wy.d[b];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float wt = wxy * wz.w[c], gx = dxy * wz.w[c], gy = xdy * wz.w[c],
                    gz = wxy * wz.d[c];
        const int64_t cell = (row + wz.i[c]) * C;
#pragma unroll
        for (int ch = 0; ch < kMaxC; ++ch)
          if (ch < C) {
            atomicAdd(dmesh + cell + ch, wt * t[ch]);
            const float v = t[ch] * __ldg(mesh + cell + ch);
            sx += v * gx;
            sy += v * gy;
            sz += v * gz;
          }
      }
    }
  dpos[3 * p] = ax ? sx : 0.f;
  dpos[3 * p + 1] = ay ? sy : 0.f;
  dpos[3 * p + 2] = az ? sz : 0.f;
}

constexpr int kThreads = 256;

unsigned blocks_for(long long n_p) { return (unsigned)((n_p + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int paint_cic_forward(const float* pos, const float* w, long long n_p, GEOM_PARAMS,
                                 float* out, void* stream) {
  const Geom g = make_geom(GEOM_ARGS);
  DISPATCH_WINDOW(order, kb, paint_cic_forward_kernel<W><<<blocks_for(n_p), kThreads, 0,
                                                     (cudaStream_t)stream>>>(pos, w, n_p, g, out));
  return (int)cudaGetLastError();
}

extern "C" int paint_cic_adjoint(const float* pos, const float* w, const float* grad,
                                 long long n_p, GEOM_PARAMS, float* dpos, float* dw,
                                 void* stream) {
  const Geom g = make_geom(GEOM_ARGS);
  DISPATCH_WINDOW(order, kb, paint_cic_adjoint_kernel<W><<<blocks_for(n_p), kThreads, 0,
                                                      (cudaStream_t)stream>>>(pos, w, grad, n_p,
                                                                              g, dpos, dw));
  return (int)cudaGetLastError();
}

extern "C" int read_cic_forward(const float* pos, const float* mesh, long long n_p, int C,
                                GEOM_PARAMS, float* out, void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(GEOM_ARGS);
  DISPATCH_WINDOW(order, kb, read_cic_forward_kernel<W><<<blocks_for(n_p), kThreads, 0,
                                                    (cudaStream_t)stream>>>(pos, mesh, n_p, C,
                                                                            g, out));
  return (int)cudaGetLastError();
}

extern "C" int read_cic_adjoint(const float* pos, const float* mesh, const float* ct,
                                long long n_p, int C, GEOM_PARAMS, float* dmesh, float* dpos,
                                void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(GEOM_ARGS);
  DISPATCH_WINDOW(order, kb, read_cic_adjoint_kernel<W><<<blocks_for(n_p), kThreads, 0,
                                                     (cudaStream_t)stream>>>(pos, mesh, ct, n_p,
                                                                             C, g, dmesh, dpos));
  return (int)cudaGetLastError();
}
