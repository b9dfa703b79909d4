// Interlaced paint (K1) and its adjoint (K2) for lattice-ordered particles;
// the C-channel read (K4) and its adjoint (K5).  Every kernel is a template
// on its window W: the B-spline BSpline<P> of order P = 1 (NGP), 2 (CIC),
// 3 (TSC) or 4 (PCS), or the Kaiser-Bessel window KaiserBessel<P> of
// support P = 1-4; the file and kernel names come from the CIC (order-2)
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
// Math, per particle p with lattice site q_p and per interlace shift
// s/n (s = 0..n-1): x = q_p + clamp(pos_p + s/n - q_p, -H, H) (the clamp is
// applied after the shift, as paint_window clamps the shifted position).
// Per axis, the base cell c0 is rint(x) for odd P (round half to even, as
// jnp.round) and floor(x) for even P; the P cells c0 - (P-1)/2 + k,
// k = 0..P-1, get the weights bspline(cell - x, P) (ops/fourier.py), and
// the P^3 products go to the periodic cells of mesh s (the Kaiser-Bessel
// window: the same cells, weights w(c - x) below).  Without a lattice
// there is no clamp (the plain scatter of ops/paint.py::paint).  NGP ties:
// paint_window rounds x - b, b its lattice group's window base, so a
// half-integer x goes to the neighbour of b's parity; with the group span B
// and margin M of that geometry (Geom::B, M) the kernels do the same, and
// without them (B = 0) they round x itself, as ops/paint.py::paint does.
//
// Kaiser-Bessel (ops/fourier.py::kaiser_bessel, Barnett et al. 2019; the
// JAX package's kernel_type='kaiser_bessel', which its Pallas window kernel
// handed back to XLA): with u = 2 (c - x) / P and z = beta sqrt(max(1 - u^2,
// 0)), w = i0(z) / norm and dw/dx = (i1(z) / z) beta^2 u (2 / P) / norm,
// i1(z) / z taken as its limit 1/2 at z = 0, where the JAX window path's
// autodiff gives NaN; beta = kcut P / 2 and 1 / norm = beta / (P sinh(beta))
// come from the host (Geom).  KB is non-zero at its support edge, and the
// stencil cells lie within |u| <= 1, so a u of 1 + eps gives the edge value.
// As in the JAX window path, the clamped window of support 1 is the one-hot
// NGP whatever W is.  A KB weight costs one cyl_bessel_i0f (the adjoints
// also one cyl_bessel_i1f) per cell and axis, computed once per particle
// and shift: 3P Bessel evaluations against P^3 corners.
//
// What bounds it on an H100: K1 is P^3 n float atomics per particle
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
// which are as local as K1's writes.  Double backward is not supported (the
// autograd wrapper is once_differentiable).
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
// (K2's rule).  Channel-last leaves room for sm_90's vector atomicAdd on
// float2/float4 (C padded to 4) in a later version.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() of its launch (cudaErrorInvalidValue for an order
// outside 1-4, or for K4/K5 a channel count outside 1-4).  The window is
// chosen at run time among the 8 instantiations of each kernel.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

struct Geom {
  int X, Y, Z;      // mesh
  int Lx, Ly, Lz;   // particle lattice (clamp only)
  float sx, sy, sz; // lattice stride in mesh cells
  float Hx, Hy, Hz; // clamp bound per axis
  int clamp;
  int n_shift;
  int Bx, By, Bz;   // NGP ties: window-group span in mesh cells, 0 for none
  int Mx, My, Mz;   // NGP ties: window margin in mesh cells
  float beta;       // Kaiser-Bessel: kcut P / 2 (unused by the B-spline)
  float inv_norm;   // Kaiser-Bessel: beta / (P sinh(beta))
};

__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ void site_of(int64_t p, const Geom& g, float& qx, float& qy,
                                        float& qz) {
  const int64_t lz = p % g.Lz;
  const int64_t t = p / g.Lz;
  const int64_t ly = t % g.Ly;
  const int64_t lx = t / g.Ly;
  qx = (float)lx * g.sx;
  qy = (float)ly * g.sy;
  qz = (float)lz * g.sz;
}

// Window base of the lattice group of site q (an integer in mesh cells),
// the origin the JAX window paint rounds NGP positions from.
__device__ __forceinline__ float group_base(float q, int B, int M) {
  return B ? (float)(((int)q / B) * B - M) : 0.f;
}

// Shifted (unclamped) position v and painted position x on one axis;
// returns whether the position derivative passes the clamp.
__device__ __forceinline__ bool place(float v, float q, float H, int clamp, float& x) {
  if (!clamp) {
    x = v;
    return true;
  }
  const float d = v - q;
  x = q + fminf(fmaxf(d, -H), H);
  return fabsf(d) < H;
}

// The P cells of one axis around x (wrapped to [0, n)), their window
// weights w and the weights' derivatives d = dw/dx.  b is the NGP tie origin.
template <int P>
struct Win {
  int i[P];
  float w[P];
  float d[P];
};

template <int P>
__device__ __forceinline__ void bspline_window(float x, int n, float b, Win<P>& o) {
  float c0;
  if constexpr (P == 1) {
    c0 = rintf(x - b) + b;
    o.w[0] = 1.f;
    o.d[0] = 0.f;
  } else if constexpr (P == 2) {
    c0 = floorf(x);
    const float t = x - c0;
    o.w[0] = 1.f - t;
    o.w[1] = t;
    o.d[0] = -1.f;
    o.d[1] = 1.f;
  } else if constexpr (P == 3) {
    c0 = rintf(x);
    const float t = x - c0;  // in [-1/2, 1/2]
    const float u = 0.5f - t, v = 0.5f + t;
    o.w[0] = 0.5f * u * u;
    o.w[1] = 0.75f - t * t;
    o.w[2] = 0.5f * v * v;
    o.d[0] = -u;
    o.d[1] = -2.f * t;
    o.d[2] = v;
  } else {
    c0 = floorf(x);
    const float t = x - c0;  // in [0, 1)
    const float u = 1.f - t;
    o.w[0] = u * u * u / 6.f;
    o.w[1] = (4.f - 6.f * t * t + 3.f * t * t * t) / 6.f;
    o.w[2] = (4.f - 6.f * u * u + 3.f * u * u * u) / 6.f;
    o.w[3] = t * t * t / 6.f;
    o.d[0] = -0.5f * u * u;
    o.d[1] = -2.f * t + 1.5f * t * t;
    o.d[2] = 2.f * u - 1.5f * u * u;
    o.d[3] = 0.5f * t * t;
  }
  const int first = (int)c0 - (P - 1) / 2;
#pragma unroll
  for (int k = 0; k < P; ++k) o.i[k] = wrap(first + k, n);
}

template <int P_>
struct BSpline {
  static constexpr int P = P_;
  static __device__ __forceinline__ void eval(float x, int n, float b, const Geom&, Win<P>& o) {
    bspline_window<P>(x, n, b, o);
  }
};

template <int P_>
struct KaiserBessel {
  static constexpr int P = P_;
  static __device__ __forceinline__ void eval(float x, int n, float b, const Geom& g,
                                              Win<P>& o) {
    if constexpr (P == 1) {
      if (g.clamp) {  // the window path's one-hot NGP
        bspline_window<1>(x, n, b, o);
        return;
      }
    }
    const float c0 = (P % 2) ? rintf(x - b) + b : floorf(x);
    const int first = (int)c0 - (P - 1) / 2;
    const float dscale = g.beta * g.beta * (2.f / (float)P) * g.inv_norm;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float u = ((float)(first + k) - x) * 2.f / (float)P;
      const float z = g.beta * sqrtf(fmaxf(1.f - u * u, 0.f));
      o.w[k] = cyl_bessel_i0f(z) * g.inv_norm;
      o.d[k] = (z > 0.f ? cyl_bessel_i1f(z) / z : 0.5f) * u * dscale;
      o.i[k] = wrap(first + k, n);
    }
  }
};

// Site, NGP tie origins of one particle (zeros without a lattice).
struct Site {
  float qx = 0.f, qy = 0.f, qz = 0.f, bx = 0.f, by = 0.f, bz = 0.f;
};

template <int P>
__device__ __forceinline__ Site site(int64_t p, const Geom& g) {
  Site s;
  if (!g.clamp) return s;
  site_of(p, g, s.qx, s.qy, s.qz);
  if constexpr (P == 1) {
    s.bx = group_base(s.qx, g.Bx, g.Mx);
    s.by = group_base(s.qy, g.By, g.My);
    s.bz = group_base(s.qz, g.Bz, g.Mz);
  }
  return s;
}

constexpr int kMaxC = 4;  // channels of one K4/K5 launch (the force read has 3)

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

Geom make_geom(int X, int Y, int Z, int Lx, int Ly, int Lz, float sx, float sy, float sz,
               float Hx, float Hy, float Hz, int clamp, int n_shift, int Bx, int By, int Bz,
               int Mx, int My, int Mz, float beta, float inv_norm) {
  return Geom{X,  Y,  Z,  Lx,    Ly,      Lz, sx, sy, sz, Hx, Hy,
              Hz, clamp, n_shift, Bx, By, Bz, Mx, My, Mz, beta, inv_norm};
}

unsigned blocks_for(long long n_p) { return (unsigned)((n_p + kThreads - 1) / kThreads); }

}  // namespace

#define GEOM_PARAMS                                                                       \
  int X, int Y, int Z, int Lx, int Ly, int Lz, float sx, float sy, float sz, float Hx,    \
      float Hy, float Hz, int clamp, int n_shift, int order, int Bx, int By, int Bz,      \
      int Mx, int My, int Mz, int kb, float beta, float inv_norm
#define GEOM_ARGS \
  X, Y, Z, Lx, Ly, Lz, sx, sy, sz, Hx, Hy, Hz, clamp, n_shift, Bx, By, Bz, Mx, My, Mz, beta, inv_norm
// Launches the kernel expression (which names the window W) at the runtime
// order and window (kb: Kaiser-Bessel, else B-spline), when there are
// particles; an order outside 1-4 returns cudaErrorInvalidValue.
#define DISPATCH_WINDOW(order, kb, ...)                                              \
  switch (2 * (order) + ((kb) ? 1 : 0)) {                                           \
    case 2: { using W = BSpline<1>; if (n_p > 0) __VA_ARGS__; } break;              \
    case 3: { using W = KaiserBessel<1>; if (n_p > 0) __VA_ARGS__; } break;         \
    case 4: { using W = BSpline<2>; if (n_p > 0) __VA_ARGS__; } break;              \
    case 5: { using W = KaiserBessel<2>; if (n_p > 0) __VA_ARGS__; } break;         \
    case 6: { using W = BSpline<3>; if (n_p > 0) __VA_ARGS__; } break;              \
    case 7: { using W = KaiserBessel<3>; if (n_p > 0) __VA_ARGS__; } break;         \
    case 8: { using W = BSpline<4>; if (n_p > 0) __VA_ARGS__; } break;              \
    case 9: { using W = KaiserBessel<4>; if (n_p > 0) __VA_ARGS__; } break;         \
    default: return (int)cudaErrorInvalidValue;                                      \
  }

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
