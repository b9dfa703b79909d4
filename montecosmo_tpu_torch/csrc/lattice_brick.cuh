// The lattice-brick decomposition shared by the tiled kernels (paint_tiled.cu:
// K1, K5 and K6, which sum a brick's corner products in a shared-memory
// tile; read_tiled.cu: K4 and K7, which gather them from a staged tile): the plan of a
// launch, a CTA's brick of lattice sites and its tile of the mesh, each
// particle's position, stencil and whether it falls in the tile, the box
// of tile cells the brick's particles reach, the outlier count, and the
// launch.  ops/paint.py::tile_plan picks the brick and margin.
#pragma once
#include "paint_window.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileCTAs = 4;  // per SM: ops/paint.py::TILE_BYTES fits four tiles

// at most kMaxSites lattice sites a brick (the fixed-point tiles' bound, and
// kMaxSites / kTileThreads particles a thread)
constexpr int kMaxSites = 1024;

// The brick and tile of one launch (ops/paint.py::tile_plan): brick in
// lattice sites, margin R and tile extent T in mesh cells.
struct Tiles {
  int b[3];
  int R;
  int T[3];
};

// One CTA's brick: its first site, its extent (smaller at the lattice's far
// edge) and its tile's origin, in unwrapped mesh cells.
struct Brick {
  int l[3], n[3], o[3];
};

template <int P>
__device__ __forceinline__ Brick brick_of(int id, const Geom& g, const Tiles& t) {
  const int L[3] = {g.Lx, g.Ly, g.Lz};
  const int s[3] = {(int)g.sx, (int)g.sy, (int)g.sz};
  const int n2 = (g.Lz + t.b[2] - 1) / t.b[2], n1 = (g.Ly + t.b[1] - 1) / t.b[1];
  const int idx[3] = {id / (n1 * n2), (id / n2) % n1, id % n2};
  Brick k;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    k.l[a] = idx[a] * t.b[a];
    k.n[a] = min(t.b[a], L[a] - k.l[a]);
    k.o[a] = k.l[a] * s[a] - t.R - (P - 1) / 2;
  }
  return k;
}

// The lattice site l and particle index of the brick's i-th site, z
// fastest as the lattice.
__device__ __forceinline__ int64_t brick_site(const Brick& k, int i, const Geom& g, int (&l)[3]) {
  const int r = i / k.n[2];
  l[0] = k.l[0] + r / k.n[1];
  l[1] = k.l[1] + r % k.n[1];
  l[2] = k.l[2] + i % k.n[2];
  return ((int64_t)l[0] * g.Ly + l[1]) * g.Lz + l[2];
}

// Whether the P cells of w lie in the tile [o, o + T) on this axis, and the
// first one's tile coordinate t0.
template <int P>
__device__ __forceinline__ bool in_tile(const Win<P>& w, int o, int T, int& t0) {
  t0 = w.lo - o;
  return t0 >= 0 && t0 + P <= T;
}

// The brick's i-th particle (z fastest, as the lattice): its index p, its
// lattice site and its position.
struct Particle {
  int64_t p;
  Site q;
  float v[3];
};

template <int P>
__device__ __forceinline__ Particle particle(const float* pos, const Brick& k, const Geom& g,
                                             int i) {
  Particle a;
  int l[3];
  a.p = brick_site(k, i, g, l);
  a.q = site_at<P>(l[0], l[1], l[2], g);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) a.v[ax] = pos[3 * a.p + ax];
  return a;
}

// Particle a's stencil at interlace shift sh: its index p, its windows,
// whether the position derivative passes the clamp on each axis, and
// whether all of its cells fall in the tile (then t0 is its first cell in
// tile coordinates).
template <class W>
struct Stencil {
  int64_t p;
  Win<W::P> w[3];
  bool pass[3];
  int t0[3];
  bool inside;
};

template <class W>
__device__ __forceinline__ void stencil(Stencil<W>& st, const Particle& a, const Brick& k,
                                        const Tiles& t, const Geom& g, float sh) {
  st.p = a.p;
  float x[3];
  st.pass[0] = place(a.v[0] + sh, a.q.qx, g.Hx, g.clamp, x[0]);
  st.pass[1] = place(a.v[1] + sh, a.q.qy, g.Hy, g.clamp, x[1]);
  st.pass[2] = place(a.v[2] + sh, a.q.qz, g.Hz, g.clamp, x[2]);
  W::eval(x[0], g.X, a.q.bx, g, st.w[0]);
  W::eval(x[1], g.Y, a.q.by, g, st.w[1]);
  W::eval(x[2], g.Z, a.q.bz, g, st.w[2]);
  st.inside = in_tile(st.w[0], k.o[0], t.T[0], st.t0[0]) &
              in_tile(st.w[1], k.o[1], t.T[1], st.t0[1]) &
              in_tile(st.w[2], k.o[2], t.T[2], st.t0[2]);
}

// Zeroes the window derivatives of every order along the axes where the
// clamp is active (K2's rule), as the double-backward kernels (K6, K7)
// take them.
template <class W>
__device__ __forceinline__ void clamp_derivatives(Stencil<W>& st) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int k = 0; k < W::P; ++k)
      if (!st.pass[a]) st.w[a].d[k] = st.w[a].d2[k] = 0.f;
}

// The box of tile cells that the CTA's in-tile particles reached, in tile
// coordinates: lo[a] <= cell < hi[a].  Each thread widens its own box;
// `reach` merges them (warp reductions, then shared-memory integer
// atomics) into the shared box, which `open_box` empties before the
// particles run (the caller's barriers order the three).
struct Box {
  int lo[3], hi[3];
};

__device__ __forceinline__ void open_box(Box& b) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.lo[a] = 1 << 30;
    b.hi[a] = -(1 << 30);
  }
}

template <int P>
__device__ __forceinline__ void widen(Box& b, const int (&t0)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.lo[a] = min(b.lo[a], t0[a]);
    b.hi[a] = max(b.hi[a], t0[a] + P);
  }
}

__device__ __forceinline__ void reach(const Box& mine, Box& shared) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int lo = __reduce_min_sync(0xffffffffu, mine.lo[a]);
    const int hi = __reduce_max_sync(0xffffffffu, mine.hi[a]);
    if (threadIdx.x % 32 == 0 && lo < hi) {
      atomicMin(&shared.lo[a], lo);
      atomicMax(&shared.hi[a], hi);
    }
  }
}

// Adds the CTA's count of corner products sent to device memory to *n_out
// (when given); `total` is a shared counter zeroed before the first barrier.
__device__ __forceinline__ void count_outliers(unsigned mine, unsigned& total,
                                               unsigned long long* n_out) {
  if (mine) atomicAdd(&total, mine);
  __syncthreads();
  if (threadIdx.x == 0 && n_out != nullptr && total) atomicAdd(n_out, (unsigned long long)total);
}

// Sets the kernel's dynamic shared memory to the tile's bytes and launches
// one CTA per brick of the lattice.
template <class... A, class... B>
int launch_tiled(void (*kernel)(A...), const Geom& g, const Tiles& t, int smem, void* stream,
                 B... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const unsigned n_brick = (unsigned)(((g.Lx + t.b[0] - 1) / t.b[0]) *
                                      ((g.Ly + t.b[1] - 1) / t.b[1]) *
                                      ((g.Lz + t.b[2] - 1) / t.b[2]));
  kernel<<<n_brick, kTileThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Whether the plan is one the kernels can take: a lattice, a brick of 1 to
// kMaxSites sites, a tile of at least one cell that fits its shared memory
// (`bytes` a value: 8 for the fixed-point paint tiles, 4 for the float
// read tiles).
bool plan_ok(const Geom& g, const Tiles& t, int C, int smem, int bytes) {
  bool ok = g.clamp && t.R >= 0 && C >= 1 && C <= kMaxC;
  long long cells = 1, sites = 1;
  for (int a = 0; a < 3; ++a) {
    ok = ok && t.b[a] >= 1 && t.T[a] >= 1;
    cells *= t.T[a];
    sites *= t.b[a];
  }
  return ok && sites <= kMaxSites && (long long)bytes * C * cells <= (long long)smem;
}

}  // namespace

#define TILE_PARAMS int bx, int by, int bz, int R, int Tx, int Ty, int Tz, int smem
