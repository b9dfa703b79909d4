// K10: bispectrum_sums, the closed-triangle sums of the FFT bispectrum
// estimator,
//
//     S_F[t] = sum_x F_i(x) F_j(x) F_l(x),   S_U[t] = sum_x U_i(x) U_j(x) U_l(x),
//
// for every bin triple t = (i, j, l) of a list (T, 3) int32, over N cells of
// B shell-filtered fields F (B, N) float32 and B unit-amplitude fields U
// (B, N) float32; out (T, 2) float64.  It replaces the triple products of
// montecosmo_tpu/metrics.py::bispectrum (:179), where XLA on the TPU ran
// jnp.mean(fs[i] * fs[j] * fs[l]) and the same over the unit fields once per
// triple (no Pallas kernel): each mean read three whole fields.
//
// What bounds it on an H100: operations.  For each l the sums are a Gram
// matrix, S[i, j, l] = sum_x (F_i F_l)(x) F_j(x): the rows of F * F_l
// against the rows of F.  So they run on the FP64 tensor cores (67 TFLOP/s
// against the CUDA cores' 34), as mma.sync m16n8k8 f64: a 16 x 8 block of
// (i, j) for one l, 8 cells deep (sm_90's m16n8k{4,8,16} f64 shapes reach
// 66-67 TFLOP/s on an H100, m8n8k4 33, as tools/dmma_rate.py measures
// them).  The host plan (ops/bispectrum.py::bispectrum_plan) groups the
// closed triples by their block (i / 16, j / 8) and cuts each block's
// range of l into strips of at most kSlots l's.
//   * A CTA owns a range of cells and 8 strips, a warp each.  It walks its
//     cells in tiles of C: cp.async copies the next tile of all B rows of F
//     and U (float32) into a second buffer while this one is used, and each
//     tile is converted once to float64 in shared memory (rows past B are
//     0, and so are cells past the range).
//   * A warp's A operand is (F_i F_l)(x), exact in float64 for two float32
//     values; its B operand F_j(x).  Lane (g, t) holds F_{16 ib + g},
//     F_{16 ib + 8 + g} and F_{8 jb + g} at the k-step's cells t and t + 4
//     in registers and reads F_l at those cells (8 distinct addresses a
//     warp: a broadcast) for each of its l's, so a k-step of 8 cells costs
//     12 + 4 nl shared loads and 8 nl products for 2 nl MMAs.  These loads,
//     the products and the staging, not the tensor cores, bound the loop:
//     it issues its MMAs at a third of the rate the cores reach alone.
//   * Each strip's sums stay in accumulator registers (2 x kSlots blocks,
//     F and U) over the CTA's whole range: no warp reduction, no shared
//     accumulator.  At the end each lane writes the block entries that are
//     closed triples to partial[cta range, t], and a second launch adds the
//     cell ranges' partials in order.
// No atomics: every sum is taken in an order that the plan fixes, so the
// result is the same bit for bit from launch to launch.  Products and sums
// are float64.
//
// Limits: B <= 390 (two float32 stages and the float64 tile of C = 16
// cells, B rounded up to 16 rows, must fit the 227 KB a CTA may use); the
// wrapper (ops/bispectrum.py) chooses C and the grid and raises beyond
// them.
//
// Plain C interface, loaded with ctypes; bispectrum_sums returns
// cudaGetLastError() after its launches.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 6;   // l's a strip holds: 2 x 6 blocks of accumulators a warp
constexpr int kPad = 4;     // a tile row's padding in doubles: conflict-free fragment loads

// D (16 x 8) += A (16 x 8) B (8 x 8) in float64 on the tensor cores: lane
// (g, t) = (lane / 4, lane % 4) gives A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4] and B[t][g], B[t + 4][g], and holds D[g][2 t],
// D[g][2 t + 1], D[g + 8][2 t], D[g + 8][2 t + 1].
__device__ __forceinline__ void mma_m16n8k8(double (&d)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// `bytes` (0 to 16) of src to dst, the rest of the 16 zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes));
}

// `bytes` (0 or 4) of src to dst, the rest of the 4 zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// One tile's cells [xs, xs + C) of the rows of F and U into raw (2 x B x C
// floats), cells at or past x1 zero-filled; 16-byte copies when `vec`
// (N a multiple of 4 and aligned rows), else 4-byte ones.  A warp takes a
// row at a time (no division a copy).
__device__ void stage_tile(float* raw, const float* F, const float* U, long long n, int B, int C,
                           long long xs, long long x1, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < 2 * B; r += kWarps) {
    const float* row = (r < B ? F + static_cast<size_t>(r) * n
                              : U + static_cast<size_t>(r - B) * n);
    float* dst = raw + static_cast<size_t>(r) * C;
    if (vec) {
      for (int c = 4 * lane; c < C; c += 128) {
        const long long left = x1 - (xs + c);
        const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * static_cast<int>(left) : 0);
        cp_async16(dst + c, row + (bytes ? xs + c : 0), bytes);
      }
    } else {
      for (int c = lane; c < C; c += 32) {
        const bool in = xs + c < x1;
        cp_async4(dst + c, row + (in ? xs + c : 0), in ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// strips (S, 4): ib, jb, l0, nl (nl = 0: an idle warp); entries (S,
// kSlots, 128): the triple at a strip's slot and block entry 8 r + c (i =
// 16 ib + r, j = 8 jb + c), or -1.  Bp: B rounded up to 16 rows.
// blockIdx.y takes strips [8 y, 8 y + 8), blockIdx.x the cells [x0, x0 +
// per); partial (gridDim.x, T, 2).
__global__ void __launch_bounds__(kThreads, 1)
    bispectrum_partials(const float* __restrict__ F, const float* __restrict__ U, long long n,
                        int B, int Bp, int C, bool vec, const int* __restrict__ strips,
                        const int* __restrict__ entries, int T, long long per,
                        double* __restrict__ partial) {
  extern __shared__ double smem[];
  const int Cs = C + kPad;
  double* tile = smem;                                              // 2 x Bp x Cs
  float* raw = reinterpret_cast<float*>(tile + 2 * static_cast<size_t>(Bp) * Cs);  // 2 x 2 B C

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int s = blockIdx.y * kWarps + warp;
  const int ib = __ldg(strips + 4 * s), jb = __ldg(strips + 4 * s + 1);
  const int l0 = __ldg(strips + 4 * s + 2), nl = __ldg(strips + 4 * s + 3);
  const long long x0 = static_cast<long long>(blockIdx.x) * per;
  const long long x1 = min(n, x0 + per);

  // the padding rows B..Bp-1 stay 0
  for (int k = threadIdx.x; k < 2 * (Bp - B) * Cs; k += kThreads) {
    const int set = k / ((Bp - B) * Cs), r = k % ((Bp - B) * Cs);
    tile[(static_cast<size_t>(set) * Bp + B) * Cs + r] = 0.0;
  }

  double cf[kSlots][4], cu[kSlots][4];
#pragma unroll
  for (int w = 0; w < kSlots; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) cf[w][e] = cu[w][e] = 0.0;

  const size_t stage = 2 * static_cast<size_t>(B) * C;
  stage_tile(raw, F, U, n, B, C, x0, x1, vec);
  int st = 0;
  for (long long xs = x0; xs < x1; xs += C, st ^= 1) {
    // the next tile's copy runs while this one is converted and used
    if (xs + C < x1) {
      stage_tile(raw + (st ^ 1) * stage, F, U, n, B, C, xs + C, x1, vec);
    } else {
      cp_async_commit();  // an empty group keeps wait_group 1's count
    }
    cp_async_wait_one();
    __syncthreads();  // this tile's copy is visible; the last tile is used
    const float* in = raw + st * stage;
    for (int r = warp; r < 2 * B; r += kWarps) {
      const float* from = in + static_cast<size_t>(r) * C;
      double* to = tile + static_cast<size_t>(r < B ? r : r - B + Bp) * Cs;
      for (int c = lane; c < C; c += 32) to[c] = static_cast<double>(from[c]);
    }
    __syncthreads();

    if (nl > 0) {
      const size_t set = static_cast<size_t>(Bp) * Cs;  // F's tile to U's
      const double* fi = tile + (16 * ib + g) * Cs + t;
      const double* fj = tile + (8 * jb + g) * Cs + t;
      const double* fl = tile + l0 * Cs + t;
      for (int k = 0; k < C; k += 8) {
        // rows i and i + 8 of the block, row j, at cells t and t + 4
        const double ai[4] = {fi[k], fi[8 * Cs + k], fi[k + 4], fi[8 * Cs + k + 4]};
        const double ui[4] = {fi[set + k], fi[set + 8 * Cs + k], fi[set + k + 4],
                              fi[set + 8 * Cs + k + 4]};
        const double bj[2] = {fj[k], fj[k + 4]};
        const double uj[2] = {fj[set + k], fj[set + k + 4]};
#pragma unroll
        for (int w = 0; w < kSlots; ++w) {
          if (w < nl) {
            const double* x = fl + w * Cs + k;
            const double f0 = x[0], f1 = x[4], u0 = x[set], u1 = x[set + 4];
            const double af[4] = {ai[0] * f0, ai[1] * f0, ai[2] * f1, ai[3] * f1};
            const double au[4] = {ui[0] * u0, ui[1] * u0, ui[2] * u1, ui[3] * u1};
            mma_m16n8k8(cf[w], af, bj);
            mma_m16n8k8(cu[w], au, uj);
          }
        }
      }
    }
  }

  // the block entries that are triples, to this cell range's partials
  double* dst = partial + static_cast<size_t>(blockIdx.x) * 2 * T;
  const int* ent = entries + static_cast<size_t>(s) * kSlots * 128;
#pragma unroll
  for (int w = 0; w < kSlots; ++w) {
    if (w < nl) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = __ldg(ent + w * 128 + 8 * (g + 8 * (e / 2)) + 2 * t + e % 2);
        if (tr >= 0) {
          dst[2 * static_cast<size_t>(tr)] = cf[w][e];
          dst[2 * static_cast<size_t>(tr) + 1] = cu[w][e];
        }
      }
    }
  }
}

// out[k] = sum over the cell ranges c, in order, of partial[c, k]
__global__ void bispectrum_reduce(const double* __restrict__ partial, int nx, long long len,
                                  double* __restrict__ out) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= len) return;
  double s = 0.0;
  for (int c = 0; c < nx; ++c) s += partial[static_cast<size_t>(c) * len + k];
  out[k] = s;
}

}  // namespace

// F, U (B, N) float32; the plan's strips (8 ny, 4) and entries (8 ny,
// kSlots, 128) int32, its tile of C cells, `per` cells a CTA along nx
// ranges, `vec` for 16-byte copies; partial (nx, T, 2) and out (T, 2)
// float64.
extern "C" int bispectrum_sums(const void* F, const void* U, long long n, int B, int Bp, int C,
                               int vec, const void* strips, const void* entries, int ny, int T,
                               long long per, int nx, void* partial, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * static_cast<size_t>(Bp) * (C + kPad) * sizeof(double) +
                      4 * static_cast<size_t>(B) * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bispectrum_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bispectrum_partials<<<dim3(nx, ny), kThreads, smem, s>>>(
      static_cast<const float*>(F), static_cast<const float*>(U), n, B, Bp, C, vec != 0,
      static_cast<const int*>(strips), static_cast<const int*>(entries), T, per,
      static_cast<double*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long len = 2LL * T;
  const int blocks = static_cast<int>((len + kThreads - 1) / kThreads);
  bispectrum_reduce<<<blocks, kThreads, 0, s>>>(static_cast<const double*>(partial), nx, len,
                                                static_cast<double*>(out));
  return cudaGetLastError();
}

