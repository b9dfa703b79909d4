// Lattice-brick K1 (the clamped paint) and K5 (the clamped read's adjoint):
// the scatter of paint_cic.cu summed in shared memory first.  Used whenever
// the geometry has a particle lattice (the clamp to the sites): every model
// paint (the render's nufft and the N-body force paint) and the N-body
// force read's VJP.  The unclamped scatter and read_multi keep the atomic
// kernels of paint_cic.cu.  Windows, clamp and geometry: paint_window.cuh.
//
// Replaces, as paint_cic.cu's K1 and K5 do, the XLA window paint
// montecosmo_tpu/ops/paint_window.py::paint_window and the deleted Pallas
// kernels ops/paint_pallas.py::paint_pallas_cic and
// ops/paint_window_pallas.py::_paint_group_kernel, which built one-hot
// windows per lattice group for the MXU; and the XLA autodiff of
// paint_window.py::read_window.
//
// What bounds the atomic design on an H100: every one of a particle's P^3
// (times C) corner products is a float atomic in L2 (K1 at 224^3 with 2
// shifts: 180M at CIC, 1.44G at PCS), so the L2 atomic rate, not the bytes,
// sets its time.  What this design does about it: the particles sit on a
// lattice and the clamp keeps each within +-H cells of its site, so the
// corners of a brick of sites fall in a small box of the mesh.  One CTA
// owns a brick of lattice sites (ops/paint.py::tile_plan picks it and the
// margin R) and sums its particles' corner products in a tile of the mesh
// in dynamic shared memory: per axis (b - 1) stride + 2 R + P cells from the
// brick's first site - R - (P-1)/2, a particle's P cells tested in
// unwrapped coordinates.  A particle whose cells do not all fall in the
// tile (displaced more than about R) sends its corners to device memory as
// the atomic kernel does, so the result never depends on R or on the
// displacements.  After a barrier the tile is folded into the mesh: the
// box of cells the in-tile particles reached, one reduction (RED) per
// touched cell at its wrapped mesh cell.  Neighbouring tiles overlap, so
// the caller zeroes the output.  K1, K5 and K6 reduce into a 64-bit
// fixed-point accumulator (mesh_fixed.cuh), the device-memory corners too,
// and a last pass turns it into floats: their meshes are the same bit for
// bit from launch to launch.
//
// On sm_90a a float atomicAdd to shared memory is a compare-and-swap loop
// (ATOMS.CAST.SPIN), which measured only ~2x the rate of the L2 atomics;
// 32-bit integer atomics are native (ATOMS.ADD).  So the tile holds fixed
// point: each CTA scales its values by 2^k from their largest magnitude
// and adds each rounded product as two 32-bit words.  The sum is exact in
// that fixed point (its quantum is ~2^-40 of the largest value) and is
// rounded once, at the fold, to the mesh's fixed point (or to float when a
// launch asks for float atomics).
//
// K1 is the C = 1 case of the tile, once per interlace shift (the tile is
// painted and folded per shift); K5 the C-channel case (the cotangent's
// channel-last paint into dmesh), and K5's position gradient
// keeps K5's gather of `mesh` at the corners (K4's access pattern).
//
// Plain C interface, loaded with ctypes, as paint_cic.cu; each entry point
// sets the tile's shared memory, launches one CTA per brick and returns
// cudaGetLastError() (cudaErrorInvalidValue for an order outside 1-4, a
// geometry without a lattice, a channel count outside 1-4, a brick of more
// than kMaxSites sites or a tile larger than its shared memory).  An
// optional counter gets the number of corner products (not channels) that
// took the device-memory path.
#include "lattice_brick.cuh"
#include "mesh_fixed.cuh"

namespace {

// A tile value in fixed point: the integer q = rint(v 2^k) of each float
// v added to it, split over two 32-bit words (lo: the low kLoBits bits of
// q, hi: the rest, q = hi 2^kLoBits + lo), because on sm_90a only 32-bit
// integer atomics are native in shared memory (a float atomicAdd there is a
// compare-and-swap loop, ATOMS.CAST.SPIN).  With at most kMaxSites
// particles per brick, each adding at most once to a cell, lo never passes
// 2^(kLoBits + 10) and the sum never 2^52.
struct Fixed {
  unsigned lo;
  int hi;
};
constexpr int kLoBits = 21;

// The CTA's scale 2^k from the largest |value| vmax of its brick (as float
// bits): n_site vmax 2^k < 2^50, which leaves a factor 4 for the window
// product (at most 1 for every window here).  ok is false for a
// non-finite value or a k outside float's exponents: the brick then goes
// to device memory whole.
struct Scale {
  float to_fixed;   // 2^k
  double to_float;  // 2^-k
  bool ok;
};

__device__ __forceinline__ Scale scale_of(unsigned vmax_bits, int n_site) {
  Scale sc{1.f, 1.0, vmax_bits < 0x7f800000u};
  if (!sc.ok || vmax_bits == 0) return sc;
  const int e = (int)(vmax_bits >> 23) - 127;  // vmax < 2^(e + 1)
  const int nb = 32 - __clz(n_site - 1);       // n_site <= 2^nb
  const int k = 50 - (e + 1) - nb;
  sc.ok = k >= -126 && k <= 127;
  if (sc.ok) {
    sc.to_fixed = __int_as_float((k + 127) << 23);
    sc.to_float = __longlong_as_double((long long)(1023 - k) << 52);
  }
  return sc;
}

// Merges the threads' largest |value| bits into `shared` (zeroed before).
__device__ __forceinline__ void reduce_max(unsigned mine, unsigned& shared) {
  mine = __reduce_max_sync(0xffffffffu, mine);
  if (threadIdx.x % 32 == 0) atomicMax(&shared, mine);
}

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

__device__ __forceinline__ void zero_tile(Fixed* tile, int n) {
  float4* t4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < n / 2; i += blockDim.x) t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n % 2 && threadIdx.x == 0) tile[n - 1] = Fixed{0u, 0};
}

__device__ __forceinline__ void add_fixed(Fixed* f, float x) {
  const long long q = __float2ll_rn(x);
  if (q != 0) {
    atomicAdd(&f->lo, (unsigned)q & ((1u << kLoBits) - 1u));
    atomicAdd(&f->hi, (int)(q >> kLoBits));
  }
}

// The P^3 corner products val[ch] W(corner) of one particle into the tile,
// its first cell at tile coordinates (tx, ty, tz), scaled to fixed point...
template <int C, int P>
__device__ __forceinline__ void tile_paint(Fixed* tile, const Tiles& t, int tx, int ty, int tz,
                                           const Win<P>& wx, const Win<P>& wy, const Win<P>& wz,
                                           const float (&val)[C], float to_fixed) {
  float v[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = val[ch] * to_fixed;
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b) {
      Fixed* row = tile + (((tx + a) * t.T[1] + ty + b) * t.T[2] + tz) * C;
      const float wab = wx.w[a] * wy.w[b];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float wt = wab * wz.w[c];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) add_fixed(row + c * C + ch, wt * v[ch]);
      }
    }
}

// ...or into the mesh at the wrapped cells (device-memory atomics, the
// atomic kernels' path), mesh cell 0 at `base`.
template <int C, int P>
__device__ __forceinline__ void mesh_paint(const MeshSum& ms, float* out, int64_t base,
                                           const Geom& g, const Win<P>& wx, const Win<P>& wy,
                                           const Win<P>& wz, const float (&val)[C]) {
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const int64_t row = ((int64_t)wx.i[a] * g.Y + wy.i[b]) * g.Z;
      const float wab = wx.w[a] * wy.w[b];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float wt = wab * wz.w[c];
        const int64_t cell = base + (row + wz.i[c]) * C;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) ms.add(out, cell + ch, wt * val[ch]);
      }
    }
}

// The fold: the box's cells of the tile (C values per cell) added into the
// (X, Y, Z, C) mesh, its cell 0 at `base`, z fastest so that a warp's
// reductions (RED) fall in few 128-byte lines, and zeroed in the tile.
// Each cell is wrapped periodically (a tile wider than the mesh adds its
// aliased cells in turn); cells that no particle reached are skipped.
// Each exact tile sum is rescaled from the brick's 2^-k to the mesh's
// fixed point, rounded once and added into the accumulator
// (mesh_fixed.cuh); without one (float atomics, `ms` without an
// accumulator) floats are added, C = 2 and 4 channels as one vector
// reduction (sm_90's float2/float4 atomicAdd).
template <int C>
__device__ __forceinline__ void fold(Fixed* tile, const Box& box, const Brick& k,
                                     const Tiles& t, const Geom& g, double to_float,
                                     const MeshSum& ms, float* out, int64_t base) {
  const int n0 = box.hi[0] - box.lo[0], n1 = box.hi[1] - box.lo[1], n2 = box.hi[2] - box.lo[2];
  const int n = n0 > 0 && n1 > 0 && n2 > 0 ? n0 * n1 * n2 : 0;
  const double to_mesh = to_float * ms.to_fixed;  // a power of two: exact
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int az = box.lo[2] + e % n2, r = e / n2;
    const int ay = box.lo[1] + r % n1, ax = box.lo[0] + r / n1;
    Fixed* cell = tile + ((ax * t.T[1] + ay) * t.T[2] + az) * C;
    long long q[C];
    bool hit = false;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const Fixed f = cell[ch];
      q[ch] = 0;
      if (f.lo | f.hi) {
        hit = true;
        cell[ch] = Fixed{0u, 0};
        q[ch] = (long long)f.hi * (1LL << kLoBits) + f.lo;
      }
    }
    if (!hit) continue;
    const int64_t at = base + (((int64_t)wrap(k.o[0] + ax, g.X) * g.Y + wrap(k.o[1] + ay, g.Y)) *
                               g.Z + wrap(k.o[2] + az, g.Z)) * C;
    if (ms.acc != nullptr) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const long long qm = __double2ll_rn((double)q[ch] * to_mesh);
        if (qm != 0) atomicAdd(ms.acc + at + ch, (unsigned long long)qm);
      }
      continue;
    }
    float v[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = (float)((double)q[ch] * to_float);
    float* dst = out + at;
    if constexpr (C == 4) {
      atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else if constexpr (C == 2) {
      atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
    } else {
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        if (v[ch] != 0.f) atomicAdd(dst + ch, v[ch]);
    }
  }
}

template <class W>
__global__ void __launch_bounds__(kTileThreads, kTileCTAs)
    paint_cic_tiled_kernel(const float* __restrict__ pos, const float* __restrict__ w, Geom g,
                           Tiles t, float* __restrict__ out, unsigned long long* n_out,
                           unsigned long long* acc, const unsigned* acc_vmax) {
  extern __shared__ float4 smem[];
  Fixed* tile = reinterpret_cast<Fixed*>(smem);
  __shared__ unsigned n_glob, vmax;
  __shared__ Box box;
  constexpr int P = W::P;
  const Brick k = brick_of<P>(blockIdx.x, g, t);
  const int n_site = k.n[0] * k.n[1] * k.n[2];
  const int64_t N = (int64_t)g.X * g.Y * g.Z;
  const MeshSum ms = mesh_sum(acc, acc_vmax, (long long)g.Lx * g.Ly * g.Lz);
  if (threadIdx.x == 0) n_glob = vmax = 0;
  zero_tile(tile, t.T[0] * t.T[1] * t.T[2]);  // each fold leaves it zeroed
  unsigned mine = 0;
  for (int i = threadIdx.x; i < n_site; i += blockDim.x) {
    int l[3];
    mine = max(mine, abs_bits(w[brick_site(k, i, g, l)]));
  }
  __syncthreads();
  reduce_max(mine, vmax);
  mine = 0;
  for (int s = 0; s < g.n_shift; ++s) {
    if (threadIdx.x == 0) open_box(box);
    __syncthreads();
    const Scale sc = scale_of(vmax, n_site);
    const float sh = (float)s / (float)g.n_shift;
    Box reached;
    open_box(reached);
    for (int i = threadIdx.x; i < n_site; i += blockDim.x) {
      Stencil<W> st;
      stencil(st, particle<P>(pos, k, g, i), k, t, g, sh);
      const float val[1] = {w[st.p]};
      if (sc.ok & st.inside) {
        tile_paint<1>(tile, t, st.t0[0], st.t0[1], st.t0[2], st.w[0], st.w[1], st.w[2], val,
                      sc.to_fixed);
        widen<P>(reached, st.t0);
      } else {
        mesh_paint<1>(ms, out, s * N, g, st.w[0], st.w[1], st.w[2], val);
        mine += P * P * P;
      }
    }
    reach(reached, box);
    __syncthreads();
    fold<1>(tile, box, k, t, g, sc.to_float, ms, out, s * N);
    __syncthreads();
  }
  count_outliers(mine, n_glob, n_out);
}

// K5: dmesh (zeroed by the caller) gets the C-channel paint of ct through
// the tile; dpos the position gradient as paint_cic.cu's K5 forms it.
template <class W, int C>
__global__ void __launch_bounds__(kTileThreads, kTileCTAs)
    read_cic_adjoint_tiled_kernel(const float* __restrict__ pos, const float* __restrict__ mesh,
                                  const float* __restrict__ ct, Geom g, Tiles t,
                                  float* __restrict__ dmesh, float* __restrict__ dpos,
                                  unsigned long long* n_out, unsigned long long* acc,
                                  const unsigned* acc_vmax) {
  extern __shared__ float4 smem[];
  Fixed* tile = reinterpret_cast<Fixed*>(smem);
  __shared__ unsigned n_glob, vmax;
  __shared__ Box box;
  constexpr int P = W::P;
  const Brick k = brick_of<P>(blockIdx.x, g, t);
  const int n_site = k.n[0] * k.n[1] * k.n[2];
  const MeshSum ms = mesh_sum(acc, acc_vmax, (long long)g.Lx * g.Ly * g.Lz);
  if (threadIdx.x == 0) {
    n_glob = vmax = 0;
    open_box(box);
  }
  zero_tile(tile, t.T[0] * t.T[1] * t.T[2] * C);
  unsigned mine = 0;
  for (int i = threadIdx.x; i < n_site; i += blockDim.x) {
    int l[3];
    const int64_t p = brick_site(k, i, g, l);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) mine = max(mine, abs_bits(ct[p * C + ch]));
  }
  __syncthreads();
  reduce_max(mine, vmax);
  mine = 0;
  __syncthreads();
  const Scale sc = scale_of(vmax, n_site);
  Box reached;
  open_box(reached);
  for (int i = threadIdx.x; i < n_site; i += blockDim.x) {
    Stencil<W> st;
    stencil(st, particle<P>(pos, k, g, i), k, t, g, 0.f);
    const Win<P>&wx = st.w[0], &wy = st.w[1], &wz = st.w[2];
    float val[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) val[ch] = ct[st.p * C + ch];
    if (sc.ok & st.inside) {
      tile_paint<C>(tile, t, st.t0[0], st.t0[1], st.t0[2], wx, wy, wz, val, sc.to_fixed);
      widen<P>(reached, st.t0);
    } else {
      mesh_paint<C>(ms, dmesh, 0, g, wx, wy, wz, val);
      mine += P * P * P;
    }
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
          const float gx = dxy * wz.w[c], gy = xdy * wz.w[c], gz = wxy * wz.d[c];
          const float* m = mesh + (row + wz.i[c]) * C;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) {
            const float v = val[ch] * __ldg(m + ch);
            sx += v * gx;
            sy += v * gy;
            sz += v * gz;
          }
        }
      }
    dpos[3 * st.p] = st.pass[0] ? sx : 0.f;
    dpos[3 * st.p + 1] = st.pass[1] ? sy : 0.f;
    dpos[3 * st.p + 2] = st.pass[2] ? sz : 0.f;
  }
  reach(reached, box);
  __syncthreads();
  fold<C>(tile, box, k, t, g, sc.to_float, ms, dmesh, 0);
  count_outliers(mine, n_glob, n_out);
}

// K6's corner values for one particle and shift, alpha W + beta . grad W
// per channel, factored per (i, j) as A_ij w_k + B_ij d_k with A_ij =
// alpha w_i w_j + beta_x d_i w_j + beta_y w_i d_j and B_ij = beta_z w_i w_j;
// add(i, j, k, ch, value) takes each.
template <int C, int P, class Add>
__device__ __forceinline__ void grad_corners(const Win<P>& wx, const Win<P>& wy,
                                             const Win<P>& wz, const float (&al)[C],
                                             const float (&be)[C][3], Add&& add) {
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const float wxy = wx.w[a] * wy.w[b], dxy = wx.d[a] * wy.w[b], xdy = wx.w[a] * wy.d[b];
      float A[C], B[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        A[ch] = al[ch] * wxy + be[ch][0] * dxy + be[ch][1] * xdy;
        B[ch] = be[ch][2] * wxy;
      }
#pragma unroll
      for (int c = 0; c < P; ++c)
#pragma unroll
        for (int ch = 0; ch < C; ++ch) add(a, b, c, ch, A[ch] * wz.w[c] + B[ch] * wz.d[c]);
    }
}

// K6: out (S meshes, zeroed by the caller) gets, shift by shift, the
// C-channel paint of alpha W + beta . grad W (alpha may be absent) through
// the tile, the derivatives of clamped axes zeroed.  The fixed-point scale
// comes from the brick's largest |alpha| + |beta_x| + |beta_y| + |beta_z|,
// which bounds every corner value (the B-spline weights and their
// derivatives are at most 1 in magnitude); the mesh's from the launch's
// (mesh_sum_begin_grad).
template <class W, int C>
__global__ void __launch_bounds__(kTileThreads, kTileCTAs)
    paint_cic_grad_tiled_kernel(const float* __restrict__ pos, const float* __restrict__ alpha,
                                const float* __restrict__ beta, Geom g, Tiles t,
                                float* __restrict__ out, unsigned long long* n_out,
                                unsigned long long* acc, const unsigned* acc_vmax) {
  extern __shared__ float4 smem[];
  Fixed* tile = reinterpret_cast<Fixed*>(smem);
  __shared__ unsigned n_glob, vmax;
  __shared__ Box box;
  constexpr int P = W::P;
  const Brick k = brick_of<P>(blockIdx.x, g, t);
  const int n_site = k.n[0] * k.n[1] * k.n[2];
  const int64_t NC = (int64_t)g.X * g.Y * g.Z * C;
  const MeshSum ms = mesh_sum(acc, acc_vmax, (long long)g.Lx * g.Ly * g.Lz);
  if (threadIdx.x == 0) n_glob = vmax = 0;
  zero_tile(tile, t.T[0] * t.T[1] * t.T[2] * C);  // each fold leaves it zeroed
  unsigned mine = 0;
  for (int i = threadIdx.x; i < n_site; i += blockDim.x) {
    int l[3];
    const int64_t p = brick_site(k, i, g, l);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float* be = beta + (p * C + ch) * 3;
      const float m = (alpha ? fabsf(alpha[p * C + ch]) : 0.f) + fabsf(be[0]) + fabsf(be[1]) +
                      fabsf(be[2]);
      mine = max(mine, abs_bits(m));
    }
  }
  __syncthreads();
  reduce_max(mine, vmax);
  mine = 0;
  for (int s = 0; s < g.n_shift; ++s) {
    if (threadIdx.x == 0) open_box(box);
    __syncthreads();
    const Scale sc = scale_of(vmax, n_site);
    const float sh = (float)s / (float)g.n_shift;
    Box reached;
    open_box(reached);
    for (int i = threadIdx.x; i < n_site; i += blockDim.x) {
      Stencil<W> st;
      stencil(st, particle<P>(pos, k, g, i), k, t, g, sh);
      clamp_derivatives(st);
      float al[C], be[C][3];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        al[ch] = alpha ? alpha[st.p * C + ch] : 0.f;
#pragma unroll
        for (int a = 0; a < 3; ++a) be[ch][a] = beta[(st.p * C + ch) * 3 + a];
      }
      const Win<P>&wx = st.w[0], &wy = st.w[1], &wz = st.w[2];
      if (sc.ok & st.inside) {
        Fixed* first = tile + ((st.t0[0] * t.T[1] + st.t0[1]) * t.T[2] + st.t0[2]) * C;
        grad_corners<C>(wx, wy, wz, al, be, [&](int a, int b, int c, int ch, float v) {
          add_fixed(first + ((a * t.T[1] + b) * t.T[2] + c) * C + ch, v * sc.to_fixed);
        });
        widen<P>(reached, st.t0);
      } else {
        grad_corners<C>(wx, wy, wz, al, be, [&](int a, int b, int c, int ch, float v) {
          ms.add(out, s * NC + (((int64_t)wx.i[a] * g.Y + wy.i[b]) * g.Z + wz.i[c]) * C + ch, v);
        });
        mine += P * P * P;
      }
    }
    reach(reached, box);
    __syncthreads();
    fold<C>(tile, box, k, t, g, sc.to_float, ms, out, s * NC);
    __syncthreads();
  }
  count_outliers(mine, n_glob, n_out);
}

}  // namespace

// acc: the fixed-point accumulator (mesh_fixed.cuh), n_shift X Y Z + 1
// int64 words; null: float atomics, in a run-dependent order.
extern "C" int paint_cic_tiled_forward(const float* pos, const float* w, GEOM_PARAMS,
                                       TILE_PARAMS, float* out, unsigned long long* n_out,
                                       unsigned long long* acc, void* stream) {
  const Geom g = make_geom(GEOM_ARGS);
  const Tiles t{{bx, by, bz}, R, {Tx, Ty, Tz}};
  if (!plan_ok(g, t, 1, smem, 8)) return (int)cudaErrorInvalidValue;
  const long long n_p = (long long)Lx * Ly * Lz;
  const long long cells = (long long)n_shift * X * Y * Z;
  const cudaStream_t s = (cudaStream_t)stream;
  if (acc != nullptr && n_p > 0) mesh_sum_begin(acc, cells, w, n_p, s);
  const unsigned* vmax = acc ? (const unsigned*)(acc + cells) : nullptr;
  int code = (int)cudaSuccess;
  DISPATCH_WINDOW(order, kb, code = launch_tiled(paint_cic_tiled_kernel<W>, g, t, smem, stream,
                                                 pos, w, g, t, out, n_out, acc, vmax));
  if (code == (int)cudaSuccess && acc != nullptr && n_p > 0) {
    mesh_sum_end(acc, cells, n_p, out, s);
    code = (int)cudaGetLastError();
  }
  return code;
}

template <class W>
int read_adjoint_tiled(int C, const Geom& g, const Tiles& t, int smem, void* stream,
                       const float* pos, const float* mesh, const float* ct, float* dmesh,
                       float* dpos, unsigned long long* n_out, unsigned long long* acc,
                       const unsigned* vmax) {
  switch (C) {
    case 1: return launch_tiled(read_cic_adjoint_tiled_kernel<W, 1>, g, t, smem, stream, pos,
                                mesh, ct, g, t, dmesh, dpos, n_out, acc, vmax);
    case 2: return launch_tiled(read_cic_adjoint_tiled_kernel<W, 2>, g, t, smem, stream, pos,
                                mesh, ct, g, t, dmesh, dpos, n_out, acc, vmax);
    case 3: return launch_tiled(read_cic_adjoint_tiled_kernel<W, 3>, g, t, smem, stream, pos,
                                mesh, ct, g, t, dmesh, dpos, n_out, acc, vmax);
    case 4: return launch_tiled(read_cic_adjoint_tiled_kernel<W, 4>, g, t, smem, stream, pos,
                                mesh, ct, g, t, dmesh, dpos, n_out, acc, vmax);
  }
  return (int)cudaErrorInvalidValue;
}

// acc: the fixed-point accumulator (mesh_fixed.cuh), X Y Z C + 1 int64
// words; null: float atomics, in a run-dependent order.
extern "C" int read_cic_adjoint_tiled(const float* pos, const float* mesh, const float* ct,
                                      int C, GEOM_PARAMS, TILE_PARAMS, float* dmesh, float* dpos,
                                      unsigned long long* n_out, unsigned long long* acc,
                                      void* stream) {
  const Geom g = make_geom(GEOM_ARGS);
  const Tiles t{{bx, by, bz}, R, {Tx, Ty, Tz}};
  if (!plan_ok(g, t, C, smem, 8)) return (int)cudaErrorInvalidValue;
  const long long n_p = (long long)Lx * Ly * Lz;
  const long long cells = (long long)X * Y * Z * C;
  const cudaStream_t s = (cudaStream_t)stream;
  if (acc != nullptr && n_p > 0) mesh_sum_begin(acc, cells, ct, n_p * C, s);
  const unsigned* vmax = acc ? (const unsigned*)(acc + cells) : nullptr;
  int code = (int)cudaSuccess;
  DISPATCH_WINDOW(order, kb, code = read_adjoint_tiled<W>(C, g, t, smem, stream, pos, mesh, ct,
                                                          dmesh, dpos, n_out, acc, vmax));
  if (code == (int)cudaSuccess && acc != nullptr && n_p > 0) {
    mesh_sum_end(acc, cells, n_p, dmesh, s);
    code = (int)cudaGetLastError();
  }
  return code;
}

template <class W>
int paint_grad_tiled(int C, const Geom& g, const Tiles& t, int smem, void* stream,
                     const float* pos, const float* alpha, const float* beta, float* out,
                     unsigned long long* n_out, unsigned long long* acc, const unsigned* vmax) {
  switch (C) {
    case 1: return launch_tiled(paint_cic_grad_tiled_kernel<W, 1>, g, t, smem, stream, pos,
                                alpha, beta, g, t, out, n_out, acc, vmax);
    case 2: return launch_tiled(paint_cic_grad_tiled_kernel<W, 2>, g, t, smem, stream, pos,
                                alpha, beta, g, t, out, n_out, acc, vmax);
    case 3: return launch_tiled(paint_cic_grad_tiled_kernel<W, 3>, g, t, smem, stream, pos,
                                alpha, beta, g, t, out, n_out, acc, vmax);
    case 4: return launch_tiled(paint_cic_grad_tiled_kernel<W, 4>, g, t, smem, stream, pos,
                                alpha, beta, g, t, out, n_out, acc, vmax);
  }
  return (int)cudaErrorInvalidValue;
}

// K6's lattice-brick design (B-spline windows: K6 takes no other).  acc:
// the fixed-point accumulator (mesh_fixed.cuh), n_shift X Y Z C + 1 int64
// words; null: float atomics, in a run-dependent order.
extern "C" int paint_cic_grad_tiled(const float* pos, const float* alpha, const float* beta_p,
                                    int C, GEOM_PARAMS, TILE_PARAMS, float* out,
                                    unsigned long long* n_out, unsigned long long* acc,
                                    void* stream) {
  const Geom g = make_geom(GEOM_ARGS);
  const Tiles t{{bx, by, bz}, R, {Tx, Ty, Tz}};
  if (kb || !plan_ok(g, t, C, smem, 8)) return (int)cudaErrorInvalidValue;
  const long long n_p = (long long)Lx * Ly * Lz;
  const long long cells = (long long)n_shift * X * Y * Z * C;
  const cudaStream_t s = (cudaStream_t)stream;
  if (acc != nullptr && n_p > 0) mesh_sum_begin_grad(acc, cells, alpha, beta_p, n_p * C, s);
  const unsigned* vmax = acc ? (const unsigned*)(acc + cells) : nullptr;
  int code = (int)cudaSuccess;
  DISPATCH_BSPLINE(order, code = paint_grad_tiled<W>(C, g, t, smem, stream, pos, alpha, beta_p,
                                                    out, n_out, acc, vmax));
  if (code == (int)cudaSuccess && acc != nullptr && n_p > 0) {
    mesh_sum_end(acc, cells, n_p, out, s);
    code = (int)cudaGetLastError();
  }
  return code;
}
