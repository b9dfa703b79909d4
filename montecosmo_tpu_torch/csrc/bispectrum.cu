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
// What bounds it on an H100: operations.  Each field is read once (2 B N
// floats), and each cell and triple takes 6 operations (two products and a
// sum, twice): at 128^3 (B = 35, T = 4,347) 5.5e10 of them against 0.6 GB.
// The design:
//   * a 2-D grid: blockIdx.y a chunk of kTriples triples, blockIdx.x a
//     contiguous range of cells.  A CTA walks its range in tiles of
//     C = 32 M cells and stages the tile's B rows of F and U in shared
//     memory as float64 (B x C each), so every field value is converted once
//     a tile, not once a triple;
//   * a warp owns a contiguous run of the CTA's triples, which come sorted
//     by (i, j, l), and a lane owns the M cells lane + 32 m of the tile: the
//     pair products F_i F_j and U_i U_j stay in registers while l runs, so
//     a triple costs two loads and two FMAs a cell;
//   * products in float64: F_i F_j of two float32 is exact there, and the
//     FMA with F_l rounds once.  A triple's tile sum is reduced across the
//     warp by an xor butterfly (a fixed order) and added by lane 0 into the
//     CTA's accumulator in shared memory, which that warp alone touches;
//   * the CTA writes its (nt, 2) sums to partial[blockIdx.x], and a second
//     launch adds the partials of the cell ranges in order.
// No float atomics anywhere, so the result is the same bit for bit from
// launch to launch (a float atomicAdd to shared memory is a CAS loop on
// sm_90a, and its order changes from run to run).
//
// Limits: B <= 390 (the tile of 2 B C doubles and the 2 kTriples
// accumulators must fit the 227 KB a CTA may use, C >= 32); the wrapper
// (ops/bispectrum.py) chooses M and the grid and raises beyond them.
//
// Plain C interface, loaded with ctypes; bispectrum_sums returns
// cudaGetLastError() after its launches.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTriples = 2048;  // a CTA's triples (its accumulators: 32 KB)

template <int M>
__global__ void __launch_bounds__(kThreads)
    bispectrum_partials(const float* __restrict__ F, const float* __restrict__ U, long long n,
                        int B, const int* __restrict__ tri, int T, long long cells_per_cta,
                        double* __restrict__ partial) {
  constexpr int C = 32 * M;
  extern __shared__ double smem[];
  double* sF = smem;                            // B x C
  double* sU = sF + static_cast<size_t>(B) * C;  // B x C
  double* acc = sU + static_cast<size_t>(B) * C;  // nt x 2

  const int t0 = blockIdx.y * kTriples;
  const int nt = min(kTriples, T - t0);
  const long long x0 = static_cast<long long>(blockIdx.x) * cells_per_cta;
  const long long x1 = min(n, x0 + cells_per_cta);
  for (int k = threadIdx.x; k < 2 * nt; k += kThreads) acc[k] = 0.0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = (nt + kWarps - 1) / kWarps;
  const int wa = min(nt, warp * per), wb = min(nt, wa + per);

  for (long long xs = x0; xs < x1; xs += C) {
    __syncthreads();  // the previous tile is read by every warp
    for (int k = threadIdx.x; k < B * C; k += kThreads) {
      const int b = k / C, c = k % C;
      const long long x = xs + c;
      const bool in = x < x1;
      sF[k] = in ? static_cast<double>(__ldg(F + static_cast<size_t>(b) * n + x)) : 0.0;
      sU[k] = in ? static_cast<double>(__ldg(U + static_cast<size_t>(b) * n + x)) : 0.0;
    }
    __syncthreads();

    int pi = -1, pj = -1;
    double pf[M], pu[M];
    for (int t = wa; t < wb; ++t) {
      const int* tr = tri + 3 * static_cast<size_t>(t0 + t);
      const int i = __ldg(tr), j = __ldg(tr + 1), l = __ldg(tr + 2);
      if (i != pi || j != pj) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int c = lane + 32 * m;
          pf[m] = sF[i * C + c] * sF[j * C + c];
          pu[m] = sU[i * C + c] * sU[j * C + c];
        }
        pi = i;
        pj = j;
      }
      double sf = 0.0, su = 0.0;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c = lane + 32 * m;
        sf = fma(pf[m], sF[l * C + c], sf);
        su = fma(pu[m], sU[l * C + c], su);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sf += __shfl_xor_sync(0xffffffffu, sf, o);
        su += __shfl_xor_sync(0xffffffffu, su, o);
      }
      if (lane == 0) {
        acc[2 * t] += sf;
        acc[2 * t + 1] += su;
      }
    }
  }
  __syncthreads();
  double* dst = partial + static_cast<size_t>(blockIdx.x) * 2 * T + 2 * static_cast<size_t>(t0);
  for (int k = threadIdx.x; k < 2 * nt; k += kThreads) dst[k] = acc[k];
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

template <int M>
int launch(const float* F, const float* U, long long n, int B, const int* tri, int T,
           long long cells_per_cta, int nx, double* partial, cudaStream_t s) {
  const size_t smem = (2 * static_cast<size_t>(B) * 32 * M + 2 * kTriples) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(bispectrum_partials<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nx, (T + kTriples - 1) / kTriples);
  bispectrum_partials<M><<<grid, kThreads, smem, s>>>(F, U, n, B, tri, T, cells_per_cta, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bispectrum_sums(const void* F, const void* U, long long n, int B, const void* tri,
                               int T, int M, long long cells_per_cta, int nx, void* partial,
                               void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = static_cast<const float*>(F);
  const auto u = static_cast<const float*>(U);
  const auto t = static_cast<const int*>(tri);
  const auto p = static_cast<double*>(partial);
  int err;
  switch (M) {
    case 8: err = launch<8>(f, u, n, B, t, T, cells_per_cta, nx, p, s); break;
    case 4: err = launch<4>(f, u, n, B, t, T, cells_per_cta, nx, p, s); break;
    case 2: err = launch<2>(f, u, n, B, t, T, cells_per_cta, nx, p, s); break;
    case 1: err = launch<1>(f, u, n, B, t, T, cells_per_cta, nx, p, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long len = 2LL * T;
  const int blocks = static_cast<int>((len + kThreads - 1) / kThreads);
  bispectrum_reduce<<<blocks, kThreads, 0, s>>>(p, nx, len, static_cast<double*>(out));
  return cudaGetLastError();
}
