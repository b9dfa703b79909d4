// Lattice-brick K4 (the clamped read): the gather of paint_cic.cu served
// from a box of the mesh staged in shared memory.  The route
// (ops/paint.py::TILED_FROM) sends the clamped K4 of TSC and PCS windows
// here: the N-body force read (ops/pm.py, read_window with clip=True) of
// the light cone at TSC.  At NGP and CIC the per-particle K4 of
// paint_cic.cu is faster.  Windows, clamp and geometry: paint_window.cuh;
// bricks, tiles, stencils and the reached box: lattice_brick.cuh.
//
// Replaces the XLA window read montecosmo_tpu/ops/paint_window.py:330
// read_window (clip=True, from every BullFrog step's pm_forces); the TPU
// formulation contracted one-hot windows against the mesh on the MXU to
// avoid gathers.
//
// What bounds the per-particle gather on an H100: one thread per particle
// loads each of its P^3 C corners from device memory through L1/L2 (at
// C = 3: 24 scalar loads a particle at CIC, 192 at PCS), a warp's loads
// span 32 + P cells of a z-row and its neighbours in y and x, which live in
// other CTAs, fetch the same lines again; and the window's wrapped cell
// indices and 64-bit row offsets cost integer work per corner.  The bytes
// alone (positions and values in, values out, the mesh once) take ~0.12 ms
// at 224^3 and C = 3; the per-particle kernel took 0.598 ms at CIC on
// scattered displacements.
//
// What this design does about it: one CTA owns a brick of lattice sites
// (ops/paint.py::tile_plan, a read tile of 4 bytes a value, 8 x 8 x 16
// sites at 224^3).  Its particles first find the box of tile cells their
// windows reach (one pass over the positions, each window's first cell
// only, merged by warp reductions); the CTA then stages that box of the
// mesh in dynamic shared memory as float32, channel-last: z-runs of the
// mesh wrapped periodically, coalesced asynchronous copies (cp.async) of
// 16 bytes where the run allows, else 4, all in flight at once, with no
// division per copy (a box wider than the mesh along an axis holds
// duplicated cells).  After one barrier each particle gathers its corners
// from shared memory with brick-local 32-bit indices.  A read needs no
// fold, no fixed point and no zeroing, and only the reached box is staged,
// so the staged bytes follow the displacements.  A particle whose window
// leaves the box (displaced more than about R) gathers from device memory
// as the per-particle kernel does, so the result never depends on R or on
// the displacements.  What it measured (PERF.md, Findings): staging the
// box costs about what it saves at NGP and CIC, where the per-particle
// gather reads few corners and the lattice order already keeps a warp's
// corners in L1; from TSC up, with 27-64 corners a particle, the staged
// box wins.  The same design for K2 (the paint's adjoint, a plane a shift)
// was slower than its per-particle gather at every order and is not kept.
//
// Plain C interface, loaded with ctypes, as paint_cic.cu; the entry point
// sets the staged tile's shared memory (the plan's whole tile, the box's
// bound), launches one CTA per brick and returns cudaGetLastError()
// (cudaErrorInvalidValue for an order outside 1-4, a geometry without a
// lattice or with interlace shifts, a channel count outside 1-4, a brick
// of more than kMaxSites sites or a tile larger than its shared memory).
// An optional counter gets the number of corner products (not channels)
// gathered from device memory.
#include "lattice_brick.cuh"

namespace {

// The first window cell on one axis of a particle at x (W::eval's `lo`,
// without the weights, which the box needs not).
template <int P>
__device__ __forceinline__ int window_lo(float x, float b) {
  const float c0 = (P % 2) ? rintf(x - b) + b : floorf(x);
  return (int)c0 - (P - 1) / 2;
}

// Widens `reached` by particle a's window at interlace shift sh when it
// falls wholly in the tile.
template <int P>
__device__ __forceinline__ void reach_particle(Box& reached, const Particle& a, const Brick& k,
                                               const Tiles& t, const Geom& g, float sh = 0.f) {
  const float qs[3] = {a.q.qx, a.q.qy, a.q.qz}, hs[3] = {g.Hx, g.Hy, g.Hz};
  const float bs[3] = {a.q.bx, a.q.by, a.q.bz};
  int t0[3];
  bool inside = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float x;
    place(a.v[ax] + sh, qs[ax], hs[ax], g.clamp, x);
    t0[ax] = window_lo<P>(x, bs[ax]) - k.o[ax];
    inside &= t0[ax] >= 0 && t0[ax] + P <= t.T[ax];
  }
  if (inside) widen<P>(reached, t0);
}

// The staged box: its first cell in tile coordinates and its extent; in
// the tile, the floats a z-run takes (`pitch`) and its first cell's offset
// in its run (`skew`); and whether it is copied 16 bytes at a time
// (`wide`).
struct Staged {
  int lo[3], n[3];
  int pitch, skew;
  bool wide;
};

// The staged box of `box` for C floats a cell of `mesh`, in `room` floats
// of shared memory.  A z-run that does not wrap, in a 16-byte aligned mesh
// whose z-lines are whole 16-byte units (Z C a multiple of 4), is staged
// from the 16-byte unit holding its first float to the one holding its
// last, when every run so widened still fits `room`; otherwise float by
// float.
template <int C>
__device__ __forceinline__ Staged staged_of(const Box& box, const Brick& k, const Geom& g,
                                            const float* mesh, int room) {
  Staged s;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    s.lo[a] = box.lo[a];
    s.n[a] = max(box.hi[a] - box.lo[a], 0);
  }
  const int run = s.n[2] * C, rows = s.n[0] * s.n[1];
  const int z0 = wrap(k.o[2] + s.lo[2], g.Z);
  const int a0 = (z0 * C) & ~3, a1 = ((z0 + s.n[2]) * C + 3) & ~3;
  s.wide = run > 0 && reinterpret_cast<uintptr_t>(mesh) % 16 == 0 && (g.Z * C) % 4 == 0 &&
           z0 + s.n[2] <= g.Z && rows * (a1 - a0) <= room;
  s.pitch = s.wide ? a1 - a0 : run;
  s.skew = s.wide ? z0 * C - a0 : 0;
  return s;
}

// Asynchronous copies from device to shared memory (cp.async, sm_80 on) of
// 4 or 16 bytes: they bypass the registers, so a thread issues all of its
// copies before it waits for the first; `copies_done` waits for all of
// them (the caller's barrier then makes them visible to the CTA).
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src));
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src));
}

__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Copies the staged box of the (X, Y, Z, C) mesh into the tile, wrapped
// periodically on every axis.  The box is s.n[0] s.n[1] z-runs, each
// `units` copies of 16 or 4 bytes; the CTA's threads are laid out as `per`
// runs of J = min(units, blockDim) consecutive copies, so that each thread
// keeps its place in the run (its z cell, wrapped once) and steps through
// the runs with the wrapped x and y carried along, with no division in the
// loop: the copies are bound by the memory, not by index arithmetic.
template <int C>
__device__ __forceinline__ void stage(float* tile, const Staged& s, const Brick& k, const Geom& g,
                                      const float* mesh) {
  const int rows = s.n[0] * s.n[1], units = s.wide ? s.pitch / 4 : s.pitch;
  if (units == 0 || rows == 0) return;
  const int J = min(units, (int)blockDim.x), per = blockDim.x / J;
  const int j0 = threadIdx.x % J, r0 = threadIdx.x / J;
  if (r0 >= per) return;
  const int q = per / s.n[1], rem = per % s.n[1];
  const int x0 = wrap(k.o[0] + s.lo[0], g.X), y0 = wrap(k.o[1] + s.lo[1], g.Y);
  const int z0 = wrap(k.o[2] + s.lo[2], g.Z);
  int rx = r0 / s.n[1], ry = r0 % s.n[1];
  for (int r = r0; r < rows; r += per) {
    int x = x0 + rx, y = y0 + ry;
    while (x >= g.X) x -= g.X;
    while (y >= g.Y) y -= g.Y;
    const float* row = mesh + ((int64_t)x * g.Y + y) * g.Z * C;
    for (int j = j0; j < units; j += J) {
      if (s.wide) {
        copy_async16(tile + r * s.pitch + 4 * j, row + z0 * C - s.skew + 4 * j);
      } else {
        int z = z0 + j / C;
        while (z >= g.Z) z -= g.Z;
        copy_async(tile + r * s.pitch + j, row + z * C + j % C);
      }
    }
    rx += q;
    ry += rem;
    if (ry >= s.n[1]) {
      ry -= s.n[1];
      ++rx;
    }
  }
  copies_done();
}

constexpr int kMaxShift = 4;  // interlace shifts of one tiled K7 launch

// Whether the window starting at tile cell t0 lies in the staged box, and
// its first cell's offset in the tile.
template <int P>
__device__ __forceinline__ bool in_staged(const Staged& s, const int (&t0)[3], int C, int& off) {
  bool in = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) in &= t0[a] >= s.lo[a] && t0[a] + P <= s.lo[a] + s.n[a];
  off = ((t0[0] - s.lo[0]) * s.n[1] + t0[1] - s.lo[1]) * s.pitch + s.skew + (t0[2] - s.lo[2]) * C;
  return in;
}

// A particle's corner cells from the staged box (`at` its first cell,
// channel-last, C values a cell), or from the mesh (MeshCells,
// paint_window.cuh).
template <int C>
struct TileCells {
  const float* at;
  int dy, dx;  // floats from a cell to its neighbour in y, in x
  __device__ __forceinline__ float operator()(int a, int b, int c, int ch) const {
    return at[a * dx + b * dy + c * C + ch];
  }
};

// K4's corner sum acc[ch] = sum W(corner) cell(corner, ch).
template <int C, int P, class Cells>
__device__ __forceinline__ void read_corners(const Cells& cell, const Win<P>& wx,
                                             const Win<P>& wy, const Win<P>& wz,
                                             float (&acc)[C]) {
#pragma unroll
  for (int a = 0; a < P; ++a)
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const float wxy = wx.w[a] * wy.w[b];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float wt = wxy * wz.w[c];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] += wt * cell(a, b, c, ch);
      }
    }
}

// The box the in-tile windows reach, merged into the shared `box` (opened
// by thread 0 before the call), then the staged box of it for C floats a
// cell; the barriers order the three.
template <int P, int C>
__device__ __forceinline__ Staged reach_all(Box& box, const float* pos, const float* mesh,
                                            const Brick& k, const Tiles& t, const Geom& g,
                                            int n_site) {
  Box reached;
  open_box(reached);
  for (int i = threadIdx.x; i < n_site; i += blockDim.x)
    reach_particle<P>(reached, particle<P>(pos, k, g, i), k, t, g);
  __syncthreads();
  reach(reached, box);
  __syncthreads();
  return staged_of<C>(box, k, g, mesh, C * t.T[0] * t.T[1] * t.T[2]);
}

// K4: out[p, ch] = sum over the P^3 corners of W(corner - x_p) mesh[corner, ch].
template <class W, int C>
__global__ void __launch_bounds__(kTileThreads, kTileCTAs)
    read_cic_tiled_kernel(const float* __restrict__ pos, const float* __restrict__ mesh, Geom g,
                          Tiles t, float* __restrict__ out, unsigned long long* n_out) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  __shared__ unsigned n_glob;
  __shared__ Box box;
  constexpr int P = W::P;
  const Brick k = brick_of<P>(blockIdx.x, g, t);
  const int n_site = k.n[0] * k.n[1] * k.n[2];
  if (threadIdx.x == 0) {
    n_glob = 0;
    open_box(box);
  }
  const Staged s = reach_all<P, C>(box, pos, mesh, k, t, g, n_site);
  stage<C>(tile, s, k, g, mesh);
  __syncthreads();
  unsigned mine = 0;
  for (int i = threadIdx.x; i < n_site; i += blockDim.x) {
    Stencil<W> st;
    stencil(st, particle<P>(pos, k, g, i), k, t, g, 0.f);
    float acc[C] = {};
    int off;
    if (st.inside && in_staged<P>(s, st.t0, C, off)) {
      const TileCells<C> cells{tile + off, s.pitch, s.n[1] * s.pitch};
      read_corners<C>(cells, st.w[0], st.w[1], st.w[2], acc);
    } else {
      const MeshCells<C, P> cells{mesh, g, st.w[0], st.w[1], st.w[2]};
      read_corners<C>(cells, st.w[0], st.w[1], st.w[2], acc);
      mine += P * P * P;
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[st.p * C + ch] = acc[ch];
  }
  count_outliers(mine, n_glob, n_out);
}

// K7: g and h of paint_hess.cu over the S interlace shifts, each shift's
// mesh M_s staged in its own region of the tile (`room` floats, a multiple
// of 4 so that every region is 16-byte aligned: the tile is planned for
// S C channels), all staged before one barrier, then each particle's
// corners summed shift by shift from the staged boxes (or from M_s for a
// window that leaves its box) with the factored sums of hess_corners.
// Two CTAs an SM, so 128 registers a thread: at K4's four (64 registers)
// its 6 C sums and three windows spill to local memory (ptxas -v).
template <class W, int C>
__global__ void __launch_bounds__(kTileThreads, 2)
    read_cic_hess_tiled_kernel(const float* __restrict__ pos, const float* __restrict__ mesh,
                               const float* __restrict__ b, Geom g, Tiles t, int room,
                               float* __restrict__ gout, float* __restrict__ hout,
                               unsigned long long* n_out) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  __shared__ unsigned n_glob;
  __shared__ Box box[kMaxShift];
  constexpr int P = W::P;
  const Brick k = brick_of<P>(blockIdx.x, g, t);
  const int n_site = k.n[0] * k.n[1] * k.n[2];
  const int64_t NC = (int64_t)g.X * g.Y * g.Z * C;
  if (threadIdx.x == 0) {
    n_glob = 0;
    for (int s = 0; s < g.n_shift; ++s) open_box(box[s]);
  }
  __syncthreads();
  for (int s = 0; s < g.n_shift; ++s) {
    Box reached;
    open_box(reached);
    const float sh = (float)s / (float)g.n_shift;
    for (int i = threadIdx.x; i < n_site; i += blockDim.x)
      reach_particle<P>(reached, particle<P>(pos, k, g, i), k, t, g, sh);
    reach(reached, box[s]);
  }
  __syncthreads();
  for (int s = 0; s < g.n_shift; ++s)
    stage<C>(tile + s * room, staged_of<C>(box[s], k, g, mesh + s * NC, room), k, g,
             mesh + s * NC);
  __syncthreads();
  unsigned mine = 0;
  for (int i = threadIdx.x; i < n_site; i += blockDim.x) {
    const Particle a = particle<P>(pos, k, g, i);
    const float bv[3] = {b[3 * a.p], b[3 * a.p + 1], b[3 * a.p + 2]};
    float gs[C][3] = {}, hs[C][3] = {};
    for (int s = 0; s < g.n_shift; ++s) {
      Stencil<W> st;
      stencil(st, a, k, t, g, (float)s / (float)g.n_shift);
      clamp_derivatives(st);
      const Staged ss = staged_of<C>(box[s], k, g, mesh + s * NC, room);
      int off;
      if (st.inside && in_staged<P>(ss, st.t0, C, off)) {
        const TileCells<C> cells{tile + s * room + off, ss.pitch, ss.n[1] * ss.pitch};
        hess_corners<C>(cells, st.w[0], st.w[1], st.w[2], bv, gs, hs);
      } else {
        const MeshCells<C, P> cells{mesh + s * NC, g, st.w[0], st.w[1], st.w[2]};
        hess_corners<C>(cells, st.w[0], st.w[1], st.w[2], bv, gs, hs);
        mine += P * P * P;
      }
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        gout[(a.p * C + ch) * 3 + ax] = gs[ch][ax];
        hout[(a.p * C + ch) * 3 + ax] = hs[ch][ax];
      }
  }
  count_outliers(mine, n_glob, n_out);
}

template <class W>
int read_tiled(int C, const Geom& g, const Tiles& t, int smem, void* stream, const float* pos,
               const float* mesh, float* out, unsigned long long* n_out) {
  switch (C) {
    case 1: return launch_tiled(read_cic_tiled_kernel<W, 1>, g, t, smem, stream, pos, mesh, g, t,
                                out, n_out);
    case 2: return launch_tiled(read_cic_tiled_kernel<W, 2>, g, t, smem, stream, pos, mesh, g, t,
                                out, n_out);
    case 3: return launch_tiled(read_cic_tiled_kernel<W, 3>, g, t, smem, stream, pos, mesh, g, t,
                                out, n_out);
    case 4: return launch_tiled(read_cic_tiled_kernel<W, 4>, g, t, smem, stream, pos, mesh, g, t,
                                out, n_out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int read_cic_tiled(const float* pos, const float* mesh, int C, GEOM_PARAMS,
                              TILE_PARAMS, float* out, unsigned long long* n_out, void* stream) {
  const Geom g = make_geom(GEOM_ARGS);
  const Tiles t{{bx, by, bz}, R, {Tx, Ty, Tz}};
  if (n_shift != 1 || !plan_ok(g, t, C, smem, 4)) return (int)cudaErrorInvalidValue;
  const long long n_p = (long long)Lx * Ly * Lz;
  int code = (int)cudaSuccess;
  DISPATCH_WINDOW(order, kb, code = read_tiled<W>(C, g, t, smem, stream, pos, mesh, out, n_out));
  return code;
}

template <class W>
int read_hess_tiled(int C, const Geom& g, const Tiles& t, int room, int smem, void* stream,
                    const float* pos, const float* mesh, const float* b, float* gout,
                    float* hout, unsigned long long* n_out) {
  switch (C) {
    case 1: return launch_tiled(read_cic_hess_tiled_kernel<W, 1>, g, t, smem, stream, pos, mesh,
                                b, g, t, room, gout, hout, n_out);
    case 2: return launch_tiled(read_cic_hess_tiled_kernel<W, 2>, g, t, smem, stream, pos, mesh,
                                b, g, t, room, gout, hout, n_out);
    case 3: return launch_tiled(read_cic_hess_tiled_kernel<W, 3>, g, t, smem, stream, pos, mesh,
                                b, g, t, room, gout, hout, n_out);
    case 4: return launch_tiled(read_cic_hess_tiled_kernel<W, 4>, g, t, smem, stream, pos, mesh,
                                b, g, t, room, gout, hout, n_out);
  }
  return (int)cudaErrorInvalidValue;
}

// K7's lattice-brick design (B-spline windows: K7 takes no other); the plan
// is a read tile of n_shift C channels, each shift's region rounded up to
// a multiple of 4 floats.
extern "C" int read_cic_hess_tiled(const float* pos, const float* mesh, const float* b, int C,
                                   GEOM_PARAMS, TILE_PARAMS, float* gout, float* hout,
                                   unsigned long long* n_out, void* stream) {
  const Geom g = make_geom(GEOM_ARGS);
  const Tiles t{{bx, by, bz}, R, {Tx, Ty, Tz}};
  const int room = (C * Tx * Ty * Tz + 3) & ~3;
  const int need = 4 * n_shift * room;
  if (kb || n_shift < 1 || n_shift > kMaxShift || need > smem + 16 * n_shift ||
      !plan_ok(g, t, C, need, 4 * n_shift))
    return (int)cudaErrorInvalidValue;
  const long long n_p = (long long)Lx * Ly * Lz;
  int code = (int)cudaSuccess;
  DISPATCH_BSPLINE(order, code = read_hess_tiled<W>(C, g, t, room, need, stream, pos, mesh, b,
                                                   gout, hout, n_out));
  return code;
}
