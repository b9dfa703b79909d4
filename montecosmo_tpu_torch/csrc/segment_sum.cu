// K9: segment_sum, the sum of the rows of src that share an id,
//
//     out[r, c] = sum_{q : idx[q] = r} src[q, c],   0 <= r < R, 0 <= c < C,
//
// for N queries q, float32 or float64 src (N, C) and int32 or int64 idx
// (N,); ids outside [0, R) are dropped (the trash segment that
// montecosmo_tpu/metrics.py::_segment_reduce (:104) slices off).  It
// replaces jax.ops.segment_sum there, and the scatter-add VJP of the table
// gather jnp.take in montecosmo_tpu/ops/interp.py::uniform_interp (:20),
// which XLA ran on the TPU; in the port it is the backward of every table
// lookup (ops/segment.py::take_rows) and the power spectrum's binning.
//
// The result is the same bit for bit from launch to launch: no float is
// ever added in an order that depends on scheduling.  The rule:
//   1. a thread sums its own contiguous run of queries in order, in
//      float64 registers, one column at a time, restarting at each change
//      of id (light-cone lookups come in lattice order, so runs are long);
//   2. at a run's end the sum is rounded once to a fixed-point integer,
//      v 2^s, and added with integer atomics: into the CTA's table in
//      shared memory (32-bit words with their carries), then, once per
//      CTA and entry, into a device-memory accumulator (64-bit words).
//      Integer addition is associative, so the final integers do not
//      depend on the order of the adds;
//   3. a last pass turns each integer back into a float, v 2^-s.
// The scale 2^s is a power of two from max |src| and N: with max |src| <
// 2^em and N < 2^en, s = 62 - em - en (float: 64-bit fixed point, two
// words) or 126 - em - en (float64: 128-bit, four words), so no sum of N
// values overflows.  max |src| comes from a first pass (atomicMax on the
// bits of |x|, which order as the values do), read on the device: nothing
// syncs with the host.  A non-finite src makes every output NaN.
// Precision: each run's sum is rounded once, to 2^-s, which is
// max|src| N 2^-62 or finer (float32 src; 2^-126 for float64).
//
// What bounds it on an H100: bytes.  The queries are read once (src, N C
// floats, and idx) and the output written once; besides, the max pass
// reads src again, and each CTA adds each row it touched to the
// accumulator once (8 or 16 bytes an entry).  The shared table holds
// rows x columns x words 32-bit words; up to kSmemBytes a launch, so a
// larger table is taken in row chunks (each launch skips the ids outside
// its rows), and more than kMaxCols columns in column chunks.
//
// Plain C interface, loaded with ctypes; segment_sum returns
// cudaGetLastError() after its launches.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;                 // columns a launch carries in registers
constexpr int kMinPerThread = 16;           // queries a thread takes at least
constexpr int kSmemBytes = 96 * 1024;       // the shared table's budget a launch
constexpr int kBlocksPerSm = 4;

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  using Bits = unsigned int;
  static constexpr int kWords = 2;        // 64-bit fixed point
  static constexpr int kMagnitude = 62;   // |sum| 2^s < 2^62
  static __device__ Bits abs_bits(float x) { return __float_as_uint(fabsf(x)); }
  static __device__ double value(Bits b) { return (double)__uint_as_float(b); }
};

template <>
struct Traits<double> {
  using Bits = unsigned long long;
  static constexpr int kWords = 4;        // 128-bit fixed point
  static constexpr int kMagnitude = 126;  // |sum| 2^s < 2^126
  static __device__ Bits abs_bits(double x) { return (Bits)__double_as_longlong(fabs(x)); }
  static __device__ double value(Bits b) { return __longlong_as_double((long long)b); }
};

// max |src| over n values, as the bits of a non-negative float: a block's
// tree in shared memory, then one atomicMax a block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    abs_max_kernel(const T* __restrict__ src, long long n, typename Traits<T>::Bits* out) {
  using Bits = typename Traits<T>::Bits;
  __shared__ Bits part[kThreads];
  Bits m = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < n; k += stride) {
    const Bits b = Traits<T>::abs_bits(src[k]);
    m = b > m ? b : m;
  }
  part[threadIdx.x] = m;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s && part[threadIdx.x + s] > part[threadIdx.x])
      part[threadIdx.x] = part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0 && part[0] != 0) atomicMax(out, part[0]);
}

// The fixed-point shift s of n values of at most max |src| (false when that
// is not finite).
template <typename T>
__device__ inline bool shift_of(const typename Traits<T>::Bits* maxbits, long long n, int* s) {
  const double m = Traits<T>::value(*maxbits);
  if (!isfinite(m)) return false;
  int em = 0, en = 0;
  frexp(m, &em);
  frexp((double)n, &en);
  *s = Traits<T>::kMagnitude - em - en;
  return true;
}

// v 2^s rounded to the nearest integer, as W 32-bit words of its two's
// complement, the lowest first.
template <int W>
__device__ inline void to_fixed(double v, int s, unsigned (&w)[W]);

template <>
__device__ inline void to_fixed<2>(double v, int s, unsigned (&w)[2]) {
  const unsigned long long u = (unsigned long long)__double2ll_rn(ldexp(v, s));
  w[0] = (unsigned)u;
  w[1] = (unsigned)(u >> 32);
}

template <>
__device__ inline void to_fixed<4>(double v, int s, unsigned (&w)[4]) {
  const double y = rint(ldexp(v, s));
  const double a = fabs(y);
  const double hi = floor(ldexp(a, -64));
  unsigned long long h = (unsigned long long)hi;
  unsigned long long l = (unsigned long long)(a - ldexp(hi, 64));  // exact: a's low bits
  if (y < 0) {
    l = ~l + 1ull;
    h = ~h + (l == 0ull ? 1ull : 0ull);
  }
  w[0] = (unsigned)l;
  w[1] = (unsigned)(l >> 32);
  w[2] = (unsigned)h;
  w[3] = (unsigned)(h >> 32);
}

// dst += w over W 32-bit words in shared memory, with 32-bit integer
// atomics (native on shared memory, 64-bit ones are not): each word's
// carry out comes from the value the atomic returns, so the W words hold
// the exact sum mod 2^(32 W) whatever the order of the adds.
template <int W>
__device__ inline void add_fixed(unsigned* dst, const unsigned (&w)[W]) {
  unsigned carry = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const unsigned add = w[j] + carry;            // mod 2^32
    const unsigned wrap = add < w[j] ? 1u : 0u;   // w[j] = 2^32 - 1 plus a carry
    if (add != 0u) {
      const unsigned old = atomicAdd(dst + j, add);
      carry = wrap | (old + add < old ? 1u : 0u);
    } else {
      carry = wrap;
    }
  }
}

// The sums of the current run, column by column, into the CTA's table.
template <typename T>
__device__ inline void flush_run(unsigned* tile, long long r, int nc, int s,
                                 const double (&run)[kMaxCols]) {
  constexpr int W = Traits<T>::kWords;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < nc && run[c] != 0.0) {
      unsigned w[W];
      to_fixed<W>(run[c], s, w);
      add_fixed<W>(tile + (r * nc + c) * W, w);
    }
  }
}

// One row and column chunk: rows [row0, row0 + rows), columns [c0, c0 +
// nc) of the (R, ld) output.  A CTA takes per_block consecutive queries,
// each thread a contiguous part of them; the CTA's table of fixed-point
// sums is then added to the device-memory accumulator acc (W / 2 64-bit
// words an entry).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ src, const I* __restrict__ idx, long long n, int ld,
                       int c0, int nc, long long row0, int rows, long long per_block,
                       const typename Traits<T>::Bits* __restrict__ maxbits,
                       unsigned long long* __restrict__ acc) {
  constexpr int W = Traits<T>::kWords;
  extern __shared__ unsigned tile[];
  int s = 0;
  if (!shift_of<T>(maxbits, n, &s)) return;  // the last pass writes NaN
  const int words = rows * nc * W;
  for (int k = threadIdx.x; k < words; k += kThreads) tile[k] = 0u;
  __syncthreads();

  const long long begin = (long long)blockIdx.x * per_block;
  const long long end = min(n, begin + per_block);
  const long long per_thread = (per_block + kThreads - 1) / kThreads;
  const long long q0 = begin + (long long)threadIdx.x * per_thread;
  const long long q1 = min(end, q0 + per_thread);
  double run[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) run[c] = 0.0;
  long long cur = -1;  // the chunk row of the current run, -1 outside the chunk
  for (long long q = q0; q < q1; ++q) {
    long long r = (long long)idx[q] - row0;
    if (r < 0 || r >= rows) r = -1;
    if (r != cur) {
      if (cur >= 0) flush_run<T>(tile, cur, nc, s, run);
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) run[c] = 0.0;
      cur = r;
    }
    if (cur >= 0) {
      const T* row = src + q * ld + c0;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c)
        if (c < nc) run[c] += (double)row[c];
    }
  }
  if (cur >= 0) flush_run<T>(tile, cur, nc, s, run);
  __syncthreads();

  for (int k = threadIdx.x; k < rows * nc; k += kThreads) {
    const unsigned* t = tile + k * W;
    const unsigned long long lo = (unsigned long long)t[0] | ((unsigned long long)t[1] << 32);
    unsigned long long* a = acc + ((row0 + k / nc) * ld + c0 + k % nc) * (W / 2);
    if constexpr (W == 2) {
      if (lo != 0ull) atomicAdd(a, lo);
    } else {
      const unsigned long long hi = (unsigned long long)t[2] | ((unsigned long long)t[3] << 32);
      if ((lo | hi) != 0ull) {
        const unsigned long long old = lo != 0ull ? atomicAdd(a, lo) : 0ull;
        const unsigned long long up = hi + (old + lo < old ? 1ull : 0ull);
        if (up != 0ull) atomicAdd(a + 1, up);
      }
    }
  }
}

// acc's integers back to floats: out[e] = acc[e] 2^-s (NaN for a
// non-finite src).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fixed_to_float_kernel(const unsigned long long* __restrict__ acc, long long n_out, long long n,
                          const typename Traits<T>::Bits* __restrict__ maxbits,
                          T* __restrict__ out) {
  constexpr int W = Traits<T>::kWords;
  int s = 0;
  const bool finite = shift_of<T>(maxbits, n, &s);
  const double qnan = __longlong_as_double(0x7ff8000000000000LL);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n_out; e += stride) {
    double v;
    if constexpr (W == 2) {
      v = (double)(long long)acc[e];
    } else {
      unsigned long long l = acc[2 * e], h = acc[2 * e + 1];
      const bool neg = (long long)h < 0;
      if (neg) {
        l = ~l + 1ull;
        h = ~h + (l == 0ull ? 1ull : 0ull);
      }
      v = ldexp((double)h, 64) + (double)l;
      if (neg) v = -v;
    }
    out[e] = (T)(finite ? ldexp(v, -s) : qnan);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
long long lmin(long long a, long long b) { return a < b ? a : b; }
long long lmax(long long a, long long b) { return a > b ? a : b; }

template <typename T, typename I>
int launch(const void* src, const void* idx, long long n, int ld, long long R, void* maxbits,
           void* acc, void* out, cudaStream_t stream) {
  using Bits = typename Traits<T>::Bits;
  constexpr int W = Traits<T>::kWords;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(segment_sum_kernel<T, I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    attr = true;
  }
  const int sms = sm_count();
  const T* s = static_cast<const T*>(src);
  const long long total = n * ld;
  const int gmax = (int)lmin((long long)kBlocksPerSm * sms, cdiv(total, kThreads));
  abs_max_kernel<T><<<gmax, kThreads, 0, stream>>>(s, total, static_cast<Bits*>(maxbits));

  const int blocks = (int)lmax(
      1, lmin((long long)kBlocksPerSm * sms, cdiv(n, (long long)kThreads * kMinPerThread)));
  const long long per_block = cdiv(n, blocks);
  const int entries = kSmemBytes / (4 * W);
  for (int c0 = 0; c0 < ld; c0 += kMaxCols) {
    const int nc = ld - c0 < kMaxCols ? ld - c0 : kMaxCols;
    const long long rows_per = entries / nc;
    for (long long r0 = 0; r0 < R; r0 += rows_per) {
      const int rows = (int)lmin(rows_per, R - r0);
      segment_sum_kernel<T, I><<<blocks, kThreads, (size_t)rows * nc * W * 4, stream>>>(
          s, static_cast<const I*>(idx), n, ld, c0, nc, r0, rows, per_block,
          static_cast<const Bits*>(maxbits), static_cast<unsigned long long*>(acc));
    }
  }
  const long long n_out = R * ld;
  const int gout = (int)lmax(1, lmin((long long)kBlocksPerSm * sms, cdiv(n_out, kThreads)));
  fixed_to_float_kernel<T><<<gout, kThreads, 0, stream>>>(
      static_cast<const unsigned long long*>(acc), n_out, n, static_cast<const Bits*>(maxbits),
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// src (n, ld) float32 or float64 (f64), idx (n,) int32 or int64 (idx64);
// maxbits one zeroed word (uint32 for float32, uint64 for float64); acc
// R ld zeroed 64-bit words (float32) or 2 R ld (float64); out (R, ld).
extern "C" int segment_sum(const void* src, const void* idx, long long n, int ld, long long R,
                           int f64, int idx64, void* maxbits, void* acc, void* out,
                           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (f64)
    return idx64 ? launch<double, long long>(src, idx, n, ld, R, maxbits, acc, out, s)
                 : launch<double, int>(src, idx, n, ld, R, maxbits, acc, out, s);
  return idx64 ? launch<float, long long>(src, idx, n, ld, R, maxbits, acc, out, s)
               : launch<float, int>(src, idx, n, ld, R, maxbits, acc, out, s);
}
