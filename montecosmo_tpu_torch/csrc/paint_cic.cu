// Interlaced CIC paint (K1) and its adjoint (K2) for lattice-ordered
// particles; the C-channel CIC read (K4) and its adjoint (K5).
//
// Replaces, on the model's main path, the XLA window paint
// montecosmo_tpu/ops/paint_window.py::paint_window (with _clip_to_sites and
// the interlace loop of montecosmo_tpu/ops/paint.py::interlace), and the two
// Pallas kernels the JAX package once had for the same math
// (ops/paint_pallas.py::paint_pallas_cic and
// ops/paint_window_pallas.py::paint_window_pallas, with its custom VJP).
//
// Math, per particle p with lattice site q_p and per interlace shift
// s/n (s = 0..n-1): x = q_p + clamp(pos_p + s/n - q_p, -H, H) (the clamp is
// applied after the shift, as paint_window clamps the shifted position);
// i0 = floor(x), f = x - i0; the 8 CIC weights prod_d (f_d or 1-f_d) go to
// the periodic cells i0 + {0,1}^3 of mesh s.  Without a lattice there is no
// clamp (the plain scatter of ops/paint.py::paint).
//
// What bounds it on an H100: K1 is 8*n float atomics per particle
// (11.24M particles x 2 shifts x 8 = 180M atomics at the 128^3 flagship
// configuration) into a 45 MB mesh per shift, i.e. the L2 atomic throughput.
// The TPU kernels built per-group one-hot windows for the MXU because
// scatters are slow there; on Hopper the atomic scatter is the natural
// form.  Design: one thread per particle, particles in lattice order so a
// warp's 32 particles share most of their corner cells and their atomics
// land in the same few L2 lines; both interlace shifts are painted in one
// pass over the particle array (positions and weights are read once).
//
// K2 gathers the 8 corners of every shift from the cotangent meshes: it
// writes dweights (the weighted read) and dpos (the read of the derivative
// window, times the weight), zeroed on the axes where the clamp was active.
// No atomics; bounded by the scattered 4-byte reads (8*n per particle), which
// are as local as K1's writes.  Double backward is not supported (the
// autograd wrapper is once_differentiable).
//
// K4 reads C fields of a channel-last (X, Y, Z, C) mesh at the same
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
// K5 is K4's VJP in one particle pass: the C-channel CIC paint of the
// cotangent into dmesh (8*C float atomics per particle, 270M at 224^3 with
// C = 3, so it is bound by the L2 atomic rate as K1 is, ~3 ms at K1's
// measured 89 G atomics/s, against ~0.2 ms of bytes) and the position
// gradient from the derivative window, zeroed on clamped axes (K2's rule).
// Channel-last leaves room for sm_90's vector atomicAdd on float2/float4
// (C padded to 4) in a later version.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() of its launch.
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

__global__ void paint_cic_forward_kernel(const float* __restrict__ pos,
                                         const float* __restrict__ w, int64_t P, Geom g,
                                         float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float px = pos[3 * p], py = pos[3 * p + 1], pz = pos[3 * p + 2];
  const float wp = w[p];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (g.clamp) site_of(p, g, qx, qy, qz);
  const int64_t N = (int64_t)g.X * g.Y * g.Z;

  for (int s = 0; s < g.n_shift; ++s) {
    const float sh = (float)s / (float)g.n_shift;
    float x, y, z;
    place(px + sh, qx, g.Hx, g.clamp, x);
    place(py + sh, qy, g.Hy, g.clamp, y);
    place(pz + sh, qz, g.Hz, g.clamp, z);
    const float fx0 = floorf(x), fy0 = floorf(y), fz0 = floorf(z);
    const float fx = x - fx0, fy = y - fy0, fz = z - fz0;
    const int ix[2] = {wrap((int)fx0, g.X), wrap((int)fx0 + 1, g.X)};
    const int iy[2] = {wrap((int)fy0, g.Y), wrap((int)fy0 + 1, g.Y)};
    const int iz[2] = {wrap((int)fz0, g.Z), wrap((int)fz0 + 1, g.Z)};
    const float wx[2] = {1.f - fx, fx};
    const float wy[2] = {1.f - fy, fy};
    const float wz[2] = {1.f - fz, fz};
    float* o = out + (int64_t)s * N;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int64_t row = ((int64_t)ix[a] * g.Y + iy[b]) * g.Z;
        const float wab = wp * (wx[a] * wy[b]);
#pragma unroll
        for (int c = 0; c < 2; ++c) atomicAdd(o + row + iz[c], wab * wz[c]);
      }
  }
}

__global__ void paint_cic_adjoint_kernel(const float* __restrict__ pos,
                                         const float* __restrict__ w,
                                         const float* __restrict__ grad, int64_t P, Geom g,
                                         float* __restrict__ dpos, float* __restrict__ dw) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float px = pos[3 * p], py = pos[3 * p + 1], pz = pos[3 * p + 2];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (g.clamp) site_of(p, g, qx, qy, qz);
  const int64_t N = (int64_t)g.X * g.Y * g.Z;

  float acc_w = 0.f, acc_x = 0.f, acc_y = 0.f, acc_z = 0.f;
  for (int s = 0; s < g.n_shift; ++s) {
    const float sh = (float)s / (float)g.n_shift;
    float x, y, z;
    const bool ax = place(px + sh, qx, g.Hx, g.clamp, x);
    const bool ay = place(py + sh, qy, g.Hy, g.clamp, y);
    const bool az = place(pz + sh, qz, g.Hz, g.clamp, z);
    const float fx0 = floorf(x), fy0 = floorf(y), fz0 = floorf(z);
    const float fx = x - fx0, fy = y - fy0, fz = z - fz0;
    const int ix[2] = {wrap((int)fx0, g.X), wrap((int)fx0 + 1, g.X)};
    const int iy[2] = {wrap((int)fy0, g.Y), wrap((int)fy0 + 1, g.Y)};
    const int iz[2] = {wrap((int)fz0, g.Z), wrap((int)fz0 + 1, g.Z)};
    const float wx[2] = {1.f - fx, fx};
    const float wy[2] = {1.f - fy, fy};
    const float wz[2] = {1.f - fz, fz};
    const float sg[2] = {-1.f, 1.f};
    const float* gs = grad + (int64_t)s * N;
    float sw = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int64_t row = ((int64_t)ix[a] * g.Y + iy[b]) * g.Z;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = __ldg(gs + row + iz[c]);
          sw += v * (wx[a] * wy[b] * wz[c]);
          sx += v * (sg[a] * wy[b] * wz[c]);
          sy += v * (wx[a] * sg[b] * wz[c]);
          sz += v * (wx[a] * wy[b] * sg[c]);
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

// Periodic cells and CIC weights of a (placed) position on one axis.
__device__ __forceinline__ void cic_axis(float x, int n, int i[2], float w[2]) {
  const float x0 = floorf(x);
  const float f = x - x0;
  i[0] = wrap((int)x0, n);
  i[1] = wrap((int)x0 + 1, n);
  w[0] = 1.f - f;
  w[1] = f;
}

// K4: vals[p, c] = sum over the 8 corners of W(corner - x_p) mesh[corner, c],
// x_p the (clamped) position; the mesh is channel-last (X, Y, Z, C).
__global__ void read_cic_forward_kernel(const float* __restrict__ pos,
                                        const float* __restrict__ mesh, int64_t P, int C,
                                        Geom g, float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (g.clamp) site_of(p, g, qx, qy, qz);
  float x, y, z;
  place(pos[3 * p], qx, g.Hx, g.clamp, x);
  place(pos[3 * p + 1], qy, g.Hy, g.clamp, y);
  place(pos[3 * p + 2], qz, g.Hz, g.clamp, z);
  int ix[2], iy[2], iz[2];
  float wx[2], wy[2], wz[2];
  cic_axis(x, g.X, ix, wx);
  cic_axis(y, g.Y, iy, wy);
  cic_axis(z, g.Z, iz, wz);
  int64_t cell[8];
  float wt[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = k >> 2, b = (k >> 1) & 1, c = k & 1;
    cell[k] = (((int64_t)ix[a] * g.Y + iy[b]) * g.Z + iz[c]) * C;
    wt[k] = wx[a] * wy[b] * wz[c];
  }
  float* o = out + p * C;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += wt[k] * __ldg(mesh + cell[k] + ch);
    o[ch] = acc;
  }
}

// K5: the VJP of K4 for a cotangent ct (P, C).  dmesh (zeroed by the caller)
// gets the C-channel CIC paint of ct (atomics); dpos gets
// sum_c ct[p, c] sum_corners grad W . mesh[corner, c], zero on the axes where
// the clamp was active (K2's rule, strict |d| < H).
__global__ void read_cic_adjoint_kernel(const float* __restrict__ pos,
                                        const float* __restrict__ mesh,
                                        const float* __restrict__ ct, int64_t P, int C,
                                        Geom g, float* __restrict__ dmesh,
                                        float* __restrict__ dpos) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (g.clamp) site_of(p, g, qx, qy, qz);
  float x, y, z;
  const bool ax = place(pos[3 * p], qx, g.Hx, g.clamp, x);
  const bool ay = place(pos[3 * p + 1], qy, g.Hy, g.clamp, y);
  const bool az = place(pos[3 * p + 2], qz, g.Hz, g.clamp, z);
  int ix[2], iy[2], iz[2];
  float wx[2], wy[2], wz[2];
  cic_axis(x, g.X, ix, wx);
  cic_axis(y, g.Y, iy, wy);
  cic_axis(z, g.Z, iz, wz);
  const float sg[2] = {-1.f, 1.f};
  int64_t cell[8];
  float wt[8], gx[8], gy[8], gz[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = k >> 2, b = (k >> 1) & 1, c = k & 1;
    cell[k] = (((int64_t)ix[a] * g.Y + iy[b]) * g.Z + iz[c]) * C;
    wt[k] = wx[a] * wy[b] * wz[c];
    gx[k] = sg[a] * wy[b] * wz[c];
    gy[k] = wx[a] * sg[b] * wz[c];
    gz[k] = wx[a] * wy[b] * sg[c];
  }
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int ch = 0; ch < C; ++ch) {
    const float t = ct[p * C + ch];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      atomicAdd(dmesh + cell[k] + ch, wt[k] * t);
      const float v = t * __ldg(mesh + cell[k] + ch);
      sx += v * gx[k];
      sy += v * gy[k];
      sz += v * gz[k];
    }
  }
  dpos[3 * p] = ax ? sx : 0.f;
  dpos[3 * p + 1] = ay ? sy : 0.f;
  dpos[3 * p + 2] = az ? sz : 0.f;
}

constexpr int kThreads = 256;

Geom make_geom(int X, int Y, int Z, int Lx, int Ly, int Lz, float sx, float sy, float sz,
               float Hx, float Hy, float Hz, int clamp, int n_shift) {
  return Geom{X, Y, Z, Lx, Ly, Lz, sx, sy, sz, Hx, Hy, Hz, clamp, n_shift};
}

}  // namespace

extern "C" int paint_cic_forward(const float* pos, const float* w, long long P, int X, int Y,
                                 int Z, int Lx, int Ly, int Lz, float sx, float sy, float sz,
                                 float Hx, float Hy, float Hz, int clamp, int n_shift,
                                 float* out, void* stream) {
  if (P > 0) {
    const Geom g = make_geom(X, Y, Z, Lx, Ly, Lz, sx, sy, sz, Hx, Hy, Hz, clamp, n_shift);
    const unsigned blocks = (unsigned)((P + kThreads - 1) / kThreads);
    paint_cic_forward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(pos, w, P, g,
                                                                            out);
  }
  return (int)cudaGetLastError();
}

extern "C" int paint_cic_adjoint(const float* pos, const float* w, const float* grad,
                                 long long P, int X, int Y, int Z, int Lx, int Ly, int Lz,
                                 float sx, float sy, float sz, float Hx, float Hy, float Hz,
                                 int clamp, int n_shift, float* dpos, float* dw,
                                 void* stream) {
  if (P > 0) {
    const Geom g = make_geom(X, Y, Z, Lx, Ly, Lz, sx, sy, sz, Hx, Hy, Hz, clamp, n_shift);
    const unsigned blocks = (unsigned)((P + kThreads - 1) / kThreads);
    paint_cic_adjoint_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(pos, w, grad, P,
                                                                            g, dpos, dw);
  }
  return (int)cudaGetLastError();
}

extern "C" int read_cic_forward(const float* pos, const float* mesh, long long P, int C, int X,
                                int Y, int Z, int Lx, int Ly, int Lz, float sx, float sy,
                                float sz, float Hx, float Hy, float Hz, int clamp, int n_shift,
                                float* out, void* stream) {
  if (P > 0) {
    const Geom g = make_geom(X, Y, Z, Lx, Ly, Lz, sx, sy, sz, Hx, Hy, Hz, clamp, n_shift);
    const unsigned blocks = (unsigned)((P + kThreads - 1) / kThreads);
    read_cic_forward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(pos, mesh, P, C, g,
                                                                           out);
  }
  return (int)cudaGetLastError();
}

extern "C" int read_cic_adjoint(const float* pos, const float* mesh, const float* ct,
                                long long P, int C, int X, int Y, int Z, int Lx, int Ly, int Lz,
                                float sx, float sy, float sz, float Hx, float Hy, float Hz,
                                int clamp, int n_shift, float* dmesh, float* dpos,
                                void* stream) {
  if (P > 0) {
    const Geom g = make_geom(X, Y, Z, Lx, Ly, Lz, sx, sy, sz, Hx, Hy, Hz, clamp, n_shift);
    const unsigned blocks = (unsigned)((P + kThreads - 1) / kThreads);
    read_cic_adjoint_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(pos, mesh, ct, P, C,
                                                                           g, dmesh, dpos);
  }
  return (int)cudaGetLastError();
}
