// The deterministic mesh sum of K1 and K5 (paint_cic.cu and paint_tiled.cu,
// both designs): every value added into the output mesh is rounded once to
// a 64-bit fixed-point integer, v 2^k, and added with an integer atomic
// into an accumulator the size of the mesh; a last pass turns each integer
// back into a float, v 2^-k.  Integer addition is associative, so the
// mesh is the same bit for bit from launch to launch, whatever order the
// atomics land in (float atomics, which the kernels used before, round
// each partial sum in that order).  The lattice-brick tiles add their
// exact fixed-point sums into the accumulator the same way, rescaled from
// the brick's scale to the mesh's.
//
// The scale 2^k comes from max |v| over the launch's values (a first pass,
// atomicMax on the bits of |v|, read on the device) and the number n of
// particles: with max |v| < 2^(e+1) and n <= 2^nb, k = 60 - (e+1) - nb, so
// a cell's sum, at most n max|v| times the window's weight sum (at most 1;
// a factor 4 is kept, as for the tiles), stays below 2^62.  The quantum
// 2^-k is max|v| n 2^-60 or finer: 2^-36 max|v| for the 224^3 lattice of
// 11.2M particles.  Non-finite values fall back to float atomics (the sum
// is not finite either).
//
// Cost: the accumulator is 8 bytes a cell (zeroed, then read once by the
// last pass, which adds into the float mesh), and the first pass reads the
// values once more.
#pragma once
#include "paint_window.cuh"

namespace {

// The accumulator of a launch and its scale; acc is null for float atomics
// (non-finite values, or a kernel that keeps them: K6).
struct MeshSum {
  unsigned long long* acc;
  double to_fixed;  // 2^k
  double to_float;  // 2^-k
  // x into cell i: into acc as fixed point, or into out with a float atomic
  __device__ __forceinline__ void add(float* out, int64_t i, float x) const {
    if (acc != nullptr) {
      const long long q = __double2ll_rn((double)x * to_fixed);
      if (q != 0) atomicAdd(acc + i, (unsigned long long)q);
    } else {
      atomicAdd(out + i, x);
    }
  }
};

// The scale of n_add particles' values of largest |v| *vmax_bits (float
// bits); float atomics when that is not finite or acc is null.
__device__ __forceinline__ MeshSum mesh_sum(unsigned long long* acc, const unsigned* vmax_bits,
                                            long long n_add) {
  if (acc == nullptr) return MeshSum{nullptr, 1.0, 1.0};
  const unsigned vb = *vmax_bits;
  if (vb >= 0x7f800000u) return MeshSum{nullptr, 1.0, 1.0};
  MeshSum m{acc, 1.0, 1.0};
  if (vb == 0) return m;
  const int e = (int)(vb >> 23) - 127;       // max|v| < 2^(e + 1)
  const int nb = 64 - __clzll(n_add - 1);    // n_add <= 2^nb
  const int k = 60 - (e + 1) - nb;           // in [-131, 186]: a double's exponent
  m.to_fixed = __longlong_as_double((long long)(1023 + k) << 52);
  m.to_float = __longlong_as_double((long long)(1023 - k) << 52);
  return m;
}

constexpr int kSumThreads = 256;

unsigned sum_blocks(long long n) {
  const long long b = (n + kSumThreads - 1) / kSumThreads;
  return (unsigned)(b < 1 ? 1 : b > 8192 ? 8192 : b);
}

// max |v| over n floats, as the bits of |v| (which order as the values do),
// into *out: a warp's max, then one atomicMax a warp.
__global__ void __launch_bounds__(kSumThreads)
    abs_max_bits(const float* __restrict__ v, long long n, unsigned* out) {
  unsigned m = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    m = max(m, __float_as_uint(v[i]) & 0x7fffffffu);
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0 && m != 0) atomicMax(out, m);
}

// out[i] += acc[i] 2^-k over the n cells (nothing when the launch fell
// back to float atomics).
__global__ void __launch_bounds__(kSumThreads)
    fixed_to_float(unsigned long long* __restrict__ acc, long long n, long long n_add,
                   float* __restrict__ out) {
  const MeshSum m = mesh_sum(acc, reinterpret_cast<const unsigned*>(acc + n), n_add);
  if (m.acc == nullptr) return;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long q = (long long)acc[i];
    if (q != 0) out[i] += (float)((double)q * m.to_float);
  }
}

// Before the launch: zero the accumulator of `cells` cells and its word of
// max |v| (acc[cells]), and find max |v| over the n_vals values.
void mesh_sum_begin(unsigned long long* acc, long long cells, const float* vals,
                    long long n_vals, cudaStream_t stream) {
  cudaMemsetAsync(acc, 0, (size_t)(cells + 1) * sizeof(unsigned long long), stream);
  abs_max_bits<<<sum_blocks(n_vals), kSumThreads, 0, stream>>>(
      vals, n_vals, reinterpret_cast<unsigned*>(acc + cells));
}

// After it: the fixed-point sums added into the float mesh `out`.
void mesh_sum_end(unsigned long long* acc, long long cells, long long n_add, float* out,
                  cudaStream_t stream) {
  fixed_to_float<<<sum_blocks(cells), kSumThreads, 0, stream>>>(acc, cells, n_add, out);
}

}  // namespace
