// The particle windows shared by the atomic kernels (paint_cic.cu: K1, K2,
// K4, K5), the lattice-brick kernels (paint_tiled.cu: tiled K1, K5 and K6;
// read_tiled.cu: tiled K4 and K7) and the per-particle double-backward
// kernels (paint_hess.cu: K6, K7): the geometry, the clamp to the lattice
// sites, the window of each particle on each axis, the mesh gather of a
// corner and K7's factored corner sums.  Every kernel is a template on its window W: the
// B-spline BSpline<P> of order P = 1 (NGP), 2 (CIC), 3 (TSC) or 4 (PCS), or
// the Kaiser-Bessel window KaiserBessel<P> of support P = 1-4.
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
#pragma once
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

// The P cells of one axis around x (wrapped to [0, n); lo the first one
// unwrapped), their window weights w, the weights' derivatives d = dw/dx
// and (the B-spline only: K7 takes no other window) their second
// derivatives d2 = d^2w/dx^2.  b is the NGP tie origin.
template <int P>
struct Win {
  int i[P];
  float w[P];
  float d[P];
  float d2[P];
  int lo;
};

template <int P>
__device__ __forceinline__ void bspline_window(float x, int n, float b, Win<P>& o) {
  float c0;
  if constexpr (P == 1) {
    c0 = rintf(x - b) + b;
    o.w[0] = 1.f;
    o.d[0] = 0.f;
    o.d2[0] = 0.f;
  } else if constexpr (P == 2) {
    c0 = floorf(x);
    const float t = x - c0;
    o.w[0] = 1.f - t;
    o.w[1] = t;
    o.d[0] = -1.f;
    o.d[1] = 1.f;
    o.d2[0] = o.d2[1] = 0.f;  // the mixed partials of the product are not
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
    o.d2[0] = 1.f;
    o.d2[1] = -2.f;
    o.d2[2] = 1.f;
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
    o.d2[0] = u;
    o.d2[1] = -2.f + 3.f * t;
    o.d2[2] = -2.f + 3.f * u;
    o.d2[3] = t;
  }
  const int first = (int)c0 - (P - 1) / 2;
  o.lo = first;
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
    o.lo = first;
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

// Site and NGP tie origins of a particle (zeros without a lattice)...
struct Site {
  float qx = 0.f, qy = 0.f, qz = 0.f, bx = 0.f, by = 0.f, bz = 0.f;
};

// ...of the particle at lattice site (lx, ly, lz)...
template <int P>
__device__ __forceinline__ Site site_at(int64_t lx, int64_t ly, int64_t lz, const Geom& g) {
  Site s;
  if (!g.clamp) return s;
  s.qx = (float)lx * g.sx;
  s.qy = (float)ly * g.sy;
  s.qz = (float)lz * g.sz;
  if constexpr (P == 1) {
    s.bx = group_base(s.qx, g.Bx, g.Mx);
    s.by = group_base(s.qy, g.By, g.My);
    s.bz = group_base(s.qz, g.Bz, g.Mz);
  }
  return s;
}

// ...and of particle p, in lattice order.
template <int P>
__device__ __forceinline__ Site site(int64_t p, const Geom& g) {
  if (!g.clamp) return Site{};
  const int64_t t = p / g.Lz;
  return site_at<P>(t / g.Ly, t % g.Ly, p % g.Lz, g);
}

constexpr int kMaxC = 4;  // channels of one K4/K5 launch (the force read has 3)

// A particle's corner cells read from the (X, Y, Z, C) mesh at the
// window's wrapped cells: cell(i, j, k, ch).
template <int C, int P>
struct MeshCells {
  const float* mesh;
  const Geom& g;
  const Win<P>&wx, &wy, &wz;
  __device__ __forceinline__ float operator()(int a, int b, int c, int ch) const {
    return __ldg(mesh + (((int64_t)wx.i[a] * g.Y + wy.i[b]) * g.Z + wz.i[c]) * C + ch);
  }
};

// K7's sums for one particle and shift: g[ch] += sum_c M[c, ch] grad W and
// h[ch] += sum_c M[c, ch] H_W b over the P^3 corners c = (i, j, k), with
// the derivatives of a clamped axis already zeroed in the windows.  Both
// are factored per (i, j): three z-sums of M against w_k, d_k and d2_k (a
// corner costs three FMAs a channel), then
//   grad W: (d_i w_j S_w, w_i d_j S_w, w_i w_j S_d),
//   H_W b:  ((d2_i w_j b0 + d_i d_j b1) S_w + d_i w_j b2 S_d,
//            (d_i d_j b0 + w_i d2_j b1) S_w + w_i d_j b2 S_d,
//            (d_i w_j b0 + w_i d_j b1) S_d + w_i w_j b2 S_h).
template <int C, int P, class Cells>
__device__ __forceinline__ void hess_corners(const Cells& cell, const Win<P>& wx,
                                             const Win<P>& wy, const Win<P>& wz,
                                             const float (&b)[3], float (&gs)[C][3],
                                             float (&hs)[C][3]) {
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float wxy = wx.w[i] * wy.w[j], dxy = wx.d[i] * wy.w[j], xdy = wx.w[i] * wy.d[j];
      const float dd = wx.d[i] * wy.d[j];
      const float hxw = wx.d2[i] * wy.w[j] * b[0] + dd * b[1], hxd = dxy * b[2];
      const float hyw = dd * b[0] + wx.w[i] * wy.d2[j] * b[1], hyd = xdy * b[2];
      const float hzd = dxy * b[0] + xdy * b[1], hzh = wxy * b[2];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        float sw = 0.f, sd = 0.f, sh = 0.f;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float v = cell(i, j, k, ch);
          sw += v * wz.w[k];
          sd += v * wz.d[k];
          sh += v * wz.d2[k];
        }
        gs[ch][0] += dxy * sw;
        gs[ch][1] += xdy * sw;
        gs[ch][2] += wxy * sd;
        hs[ch][0] += hxw * sw + hxd * sd;
        hs[ch][1] += hyw * sw + hyd * sd;
        hs[ch][2] += hzd * sd + hzh * sh;
      }
    }
}

Geom make_geom(int X, int Y, int Z, int Lx, int Ly, int Lz, float sx, float sy, float sz,
               float Hx, float Hy, float Hz, int clamp, int n_shift, int Bx, int By, int Bz,
               int Mx, int My, int Mz, float beta, float inv_norm) {
  return Geom{X,  Y,  Z,  Lx,    Ly,      Lz, sx, sy, sz, Hx, Hy,
              Hz, clamp, n_shift, Bx, By, Bz, Mx, My, Mz, beta, inv_norm};
}

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
// The same for the B-spline windows alone (the double-backward kernels
// take no other).
#define DISPATCH_BSPLINE(order, ...)                                  \
  switch (order) {                                                    \
    case 1: { using W = BSpline<1>; if (n_p > 0) __VA_ARGS__; } break; \
    case 2: { using W = BSpline<2>; if (n_p > 0) __VA_ARGS__; } break; \
    case 3: { using W = BSpline<3>; if (n_p > 0) __VA_ARGS__; } break; \
    case 4: { using W = BSpline<4>; if (n_p > 0) __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;                       \
  }
