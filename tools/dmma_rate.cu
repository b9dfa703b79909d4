// The FP64 tensor cores' rate by mma.sync shape on sm_90a, for
// tools/dmma_rate.py: each warp issues `iters` rounds of 8 independent
// MMAs of one shape on operands held in registers.  Shapes: 0 m8n8k4 (the
// sm_80 shape), 1 m16n8k4, 2 m16n8k8 (K10's, csrc/bispectrum.cu), 3
// m16n8k16.
#include <cuda_runtime.h>

#define MMA884(d, a, b)                                                              \
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, " \
               "{%0,%1};"                                                            \
               : "+d"(d[0]), "+d"(d[1])                                              \
               : "d"(a[0]), "d"(b[0]))
#define MMA1684(d, a, b)                                                                 \
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, " \
               "{%6}, {%0,%1,%2,%3};"                                                    \
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])                          \
               : "d"(a[0]), "d"(a[1]), "d"(b[0]))
#define MMA1688(d, a, b)                                                             \
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "     \
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"                              \
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])                      \
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]))
#define MMA16816(d, a, b)                                                                \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "        \
               "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"           \
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])                          \
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),       \
                 "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]))

namespace {

template <int S>
__global__ void __launch_bounds__(256) dmma_loop(double* out, int iters) {
  constexpr int NA = S == 0 ? 1 : S == 1 ? 2 : S == 2 ? 4 : 8;
  constexpr int NB = S < 2 ? 1 : S == 2 ? 2 : 4;
  constexpr int NC = S == 0 ? 2 : 4;
  double a[NA], b[NB], d[8][NC];
  for (int i = 0; i < NA; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < NB; ++i) b[i] = 1.0 + 1e-4 * (threadIdx.x + i);
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < NC; ++i) d[j][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (S == 0) MMA884(d[j], a, b);
      if constexpr (S == 1) MMA1684(d[j], a, b);
      if constexpr (S == 2) MMA1688(d[j], a, b);
      if constexpr (S == 3) MMA16816(d[j], a, b);
    }
  }
  double s = 0.0;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < NC; ++i) s += d[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// `blocks` CTAs of 256 threads; out holds a double a thread.
extern "C" int dmma_loop(int shape, int blocks, int iters, double* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: dmma_loop<0><<<blocks, 256, 0, s>>>(out, iters); break;
    case 1: dmma_loop<1><<<blocks, 256, 0, s>>>(out, iters); break;
    case 2: dmma_loop<2><<<blocks, 256, 0, s>>>(out, iters); break;
    default: dmma_loop<3><<<blocks, 256, 0, s>>>(out, iters); break;
  }
  return cudaGetLastError();
}
