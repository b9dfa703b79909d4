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
// added in an order that depends on scheduling.  One launch:
//   1. Warp w of CTA b takes a contiguous range of queries (the plan's
//      per_warp) in batches of U rounds of 32: lane q reads query base + q
//      of each round, so a warp's loads of src and idx are coalesced, and
//      the next batch loads while this one is summed.  A round whose 32
//      ids are one row adds to a run carried over whole rounds, each lane
//      its own float64 sum (an xor butterfly ends it).  In any other round
//      a lane compares its id with its neighbour's (__shfl_up_sync) and a
//      segmented warp scan sums each run of equal ids in float64 (a fixed
//      tree, cut short once every lane has reached the head of its run),
//      so the run's last lane holds its sum.
//   2. Each run's sum is rounded once to a fixed-point integer, v 2^s, and
//      added to the CTA's table in shared memory with 32-bit integer
//      atomics and their carries (64-bit words for float32 src, 128-bit
//      for float64).  Integer addition is associative, so the table does
//      not depend on the order of the adds.  The scale 2^s is the CTA's
//      own: before each batch the CTA's warps agree (two __syncthreads) on
//      the largest exponent of the values met so far, e, and s = kMag - e
//      - log2(the CTA's queries), so no sum can overflow; when e grows the
//      table is shifted right (rounded) to the new scale, and rows met for
//      the first time are zeroed.  The sequence of scales is fixed by the
//      data and the plan.
//   3. The CTA turns its table into float64, v 2^-s, over the rows it
//      touched and writes them, with that row range, to scratch.  A ticket
//      counter picks the last CTA of each group of kGroup to finish: it
//      sums the group's partials in a pairwise (tree) order over the CTAs,
//      every member's load in flight at once; the last group to finish sums
//      the groups the same way and writes out, 0 where no query fell.  The
//      counters wrap to 0 by themselves (atomicInc), so nothing is zeroed
//      before a launch.
// Precision: each run's sum is rounded once, to 2^-s: a 2^-62 (float32
// src) or 2^-126 (float64) share of the CTA's largest value times its
// queries; then float64 sums of the CTAs' partials, rounded once to src's
// dtype.  A non-finite value makes its CTA's rows NaN.
//
// What bounds it on an H100: bytes.  src (N C values) and idx are read
// once and out written once; each CTA also writes its touched rows' float64
// partials and the group finishers read them back (R C 8 bytes a CTA at
// most).  One launch a call while the CTA's table (R C words) fits; wider
// tables are taken in row chunks and more than kMaxCols columns in column
// chunks, a launch each, each launch dropping the ids outside its rows.
//
// Plain C interface, loaded with ctypes; segment_sum returns
// cudaGetLastError() after its launches.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;     // warps a CTA
constexpr int kMaxCols = 8;   // columns a launch carries in registers
constexpr int kGroup = 16;    // CTAs a group finisher sums
constexpr int kTop = 32;      // groups the last finisher sums in one tree
constexpr int kMaxGroups = 64;  // groups a launch may have (ops/segment.py checks)
constexpr int kNone = -2000;  // the exponent before any nonzero value

// Queries a lane loads ahead, by the columns it carries: 16 values in
// registers whatever the width, so that each warp keeps loads in flight.
template <int CM>
struct Unroll {
  static constexpr int value = 16 / CM;
};

// The fixed point of src's type: W 32-bit words an entry, |sum| 2^s below
// 2^kMag.  `bits` is |x|'s bit pattern (which orders as |x| does), and
// `exponent` of the largest bits the e with |x| < 2^e: INT_MAX when it is
// not finite, kNone for 0.
template <typename T>
struct Fixed;

template <>
struct Fixed<float> {
  static constexpr int W = 2, kMag = 62;
  static __device__ unsigned long long bits(float x) { return __float_as_uint(x) & 0x7fffffffu; }
  static __device__ int exponent(unsigned long long m) {
    const int b = (int)(m >> 23);
    return b == 0xff ? INT_MAX : (m == 0ull ? kNone : (b == 0 ? -126 : b - 126));
  }
};

template <>
struct Fixed<double> {
  static constexpr int W = 4, kMag = 126;
  static __device__ unsigned long long bits(double x) {
    return (unsigned long long)__double_as_longlong(x) & 0x7fffffffffffffffull;
  }
  static __device__ int exponent(unsigned long long m) {
    const int b = (int)(m >> 52);
    return b == 0x7ff ? INT_MAX : (m == 0ull ? kNone : (b == 0 ? -1022 : b - 1022));
  }
};

// v 2^s: a product by 2^s where that is a normal double, else ldexp.
__device__ __forceinline__ double scaled(double v, int s) {
  return s >= -1022 && s <= 1023 ? v * __longlong_as_double((long long)(s + 1023) << 52)
                                 : ldexp(v, s);
}

// The pairwise sum of N values (N a power of two) in a fixed tree: the
// members that add nothing hold 0, so the order of the additions depends
// on N alone.
template <int N>
__device__ __forceinline__ double tree_sum(double (&v)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] = v[2 * i] + v[2 * i + 1];
  }
  return v[0];
}

// The CTA's table keeps word j of entry e = c rows + r at tab[j E + e], so
// lanes that add to random rows spread over the banks.

// tab[e] += v 2^s, v 2^s rounded to the nearest integer, W words of its
// two's complement, the lowest first, each with a 32-bit atomic whose
// returned value gives the carry into the next: the words hold the exact
// sum mod 2^(32 W) whatever the order of the adds.
template <int W>
__device__ __forceinline__ void add_fixed(unsigned* tab, int E, int e, double v, int s) {
  unsigned w[W];
  if constexpr (W == 2) {
    const unsigned long long u = (unsigned long long)__double2ll_rn(scaled(v, s));
    w[0] = (unsigned)u;
    w[1] = (unsigned)(u >> 32);
  } else {
    const double y = rint(scaled(v, s));
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
  unsigned carry = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const unsigned add = w[j] + carry;            // mod 2^32
    const unsigned wrap = add < w[j] ? 1u : 0u;   // w[j] = 2^32 - 1 plus a carry
    if (add != 0u) {
      const unsigned old = atomicAdd(tab + j * E + e, add);
      carry = wrap | (old + add < old ? 1u : 0u);
    } else {
      carry = wrap;
    }
  }
}

// Entry e as a signed (32 W)-bit integer.
template <int W>
__device__ __forceinline__ __int128 read_fixed(const unsigned* tab, int E, int e) {
  unsigned __int128 u = 0;
#pragma unroll
  for (int j = W - 1; j >= 0; --j) u = (u << 32) | tab[j * E + e];
  if constexpr (W == 2) return (__int128)(long long)(unsigned long long)u;
  return (__int128)u;
}

// Entry e as a float64, v 2^-s.
template <int W>
__device__ __forceinline__ double fixed_value(const unsigned* tab, int E, int e, int s) {
  const __int128 x = read_fixed<W>(tab, E, e);
  const bool neg = x < 0;
  const unsigned __int128 a = neg ? (unsigned __int128)(-x) : (unsigned __int128)x;
  const double v = ldexp((double)(unsigned long long)(a >> 64), 64) +
                   (double)(unsigned long long)a;
  return ldexp(neg ? -v : v, -s);
}

// Entry e shifted right by d > 0 bits, rounded half up: the same sum at
// the scale 2^(s - d).
template <int W>
__device__ __forceinline__ void shift_fixed(unsigned* tab, int E, int e, int d) {
  __int128 x = read_fixed<W>(tab, E, e);
  x = d >= 32 * W - 1 ? (__int128)0 : (x + ((__int128)1 << (d - 1))) >> d;
  const unsigned __int128 u = (unsigned __int128)x;
#pragma unroll
  for (int j = 0; j < W; ++j) tab[j * E + e] = (unsigned)(u >> (32 * j));
}

// Group finisher: the sums of `members` (<= kGroup) partials of E entries
// each, partial m at part + m E, whose row ranges are in range[2 m],
// range[2 m + 1], in a fixed pairwise tree over the member slots, over the
// rows [lo, hi] of their union.  The members' loads are issued together
// (rows outside a range are loaded and dropped: the scratch there holds
// whatever it held).
__device__ void sum_members(const double* part, const int* range, int members, int rows,
                            int nc, int lo, int hi, double* dst) {
  const int span = lo <= hi ? hi - lo + 1 : 0;
  for (int k = threadIdx.x; k < span * nc; k += blockDim.x) {
    const int c = k / span, r = lo + k % span;
    const long long e = (long long)c * rows + r;
    double v[kGroup];
#pragma unroll
    for (int m = 0; m < kGroup; ++m)
      v[m] = m < members ? __ldcg(part + m * (long long)rows * nc + e) : 0.0;
#pragma unroll
    for (int m = 0; m < kGroup; ++m)
      if (!(m < members && range[2 * m] <= r && r <= range[2 * m + 1])) v[m] = 0.0;
    dst[e] = tree_sum(v);
  }
}

// The union of `members` row ranges in shared memory (lo > hi when all
// are empty).
__device__ int2 union_range(const int* range, int members) {
  int lo = INT_MAX, hi = -1;
  for (int m = 0; m < members; ++m) {
    if (range[2 * m] <= range[2 * m + 1]) {
      lo = min(lo, range[2 * m]);
      hi = max(hi, range[2 * m + 1]);
    }
  }
  return make_int2(lo, hi);
}

// One batch of U x 32 queries of a warp into registers: lane q takes
// queries base + 32 u + q (coalesced); id -1 past q1.  The values load
// whatever the ids (no load waits on another).
template <typename T, typename I, int CM>
__device__ __forceinline__ void load_batch(const T* __restrict__ src, const I* __restrict__ idx,
                                           long long base, long long q1, int ld, int c0, int nc,
                                           long long (&id)[Unroll<CM>::value],
                                           T (&v)[Unroll<CM>::value][CM]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < Unroll<CM>::value; ++u) {
    const long long q = base + 32 * u + lane;
    id[u] = -1;
#pragma unroll
    for (int c = 0; c < CM; ++c) v[u][c] = T(0);
    if (q < q1) {
      id[u] = (long long)__ldg(idx + q);
      const T* row = src + q * ld + c0;
#pragma unroll
      for (int c = 0; c < CM; ++c)
        if (c < nc) v[u][c] = __ldg(row + c);
    }
  }
}

// The end of a carried run (a run that filled whole rounds of 32): its
// lanes' sums by an xor butterfly, lane 0's added, then no run is carried.
template <int W, int CM>
__device__ __forceinline__ void end_carry(unsigned* tab, int rows, int nc, int s, int& carry,
                                          double (&cacc)[CM]) {
  if (carry < 0) return;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    for (int o = 16; o > 0; o >>= 1) cacc[c] += __shfl_xor_sync(kFull, cacc[c], o);
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int c = 0; c < CM; ++c)
      if (c < nc) add_fixed<W>(tab, rows * nc, c * rows + carry, cacc[c], s);
  }
#pragma unroll
  for (int c = 0; c < CM; ++c) cacc[c] = 0.0;
  carry = -1;
}

// One launch: rows [row0, row0 + rows), columns [c0, c0 + nc) of the (R,
// ld) output.  Scratch: partial (ctas + groups) x nc rows doubles, range
// (ctas + groups) x 2 ints; counters 1 + groups words that are 0 between
// launches.
template <typename T, typename I, int CM>
__global__ void __launch_bounds__(32 * kWarps, 2)
    segment_sum_kernel(const T* __restrict__ src, const I* __restrict__ idx, long long n, int ld,
                       int c0, int nc, long long row0, int rows, long long per_warp,
                       double* __restrict__ partial, int* __restrict__ ranges,
                       unsigned* __restrict__ counters, T* __restrict__ out) {
  constexpr int U = Unroll<CM>::value;
  constexpr int W = Fixed<T>::W;
  extern __shared__ unsigned tab[];  // W x E words
  __shared__ int wexp[kWarps], wlo[kWarps], whi[kWarps];
  __shared__ int wrange[2 * kGroup];
  __shared__ int gr_ranges[2 * kMaxGroups];
  __shared__ int last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = rows * nc;
  const int ctas = gridDim.x, groups = (ctas + kGroup - 1) / kGroup;

  // 1-2: the warps' queries, a batch of U x 32 each at a time, the next
  // batch loading while this one is summed
  int lo = INT_MAX, hi = -1;  // the rows the CTA has zeroed (uniform)
  int e_max = kNone;          // the largest exponent met (uniform)
  int en = 0;                 // 2^en > the CTA's queries
  while ((1ll << en) <= kWarps * per_warp) ++en;
  int s = 0;                  // the table's scale 2^s
  int carry = -1;             // the row of a run that fills whole rounds of 32 (uniform)
  double cacc[CM];            // its sums so far, one a lane (lane order is fixed)
#pragma unroll
  for (int c = 0; c < CM; ++c) cacc[c] = 0.0;
  const long long q0 = ((long long)blockIdx.x * kWarps + warp) * per_warp;
  const long long q1 = min(n, q0 + per_warp);
  long long nid[U];
  T nv[U][CM];
  load_batch<T, I, CM>(src, idx, q0, q1, ld, c0, nc, nid, nv);
  for (long long base = q0; base < q0 + per_warp; base += 32 * U) {
    int key[U];  // each id as its row in the chunk, -1 when it is dropped
    double v[U][CM];
    unsigned long long mb = 0ull;  // the largest |x| of the kept values, as bits
    int kmin = INT_MAX, kmax = -1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = nid[u] - row0;
      key[u] = nid[u] >= 0 && r >= 0 && r < rows ? (int)r : -1;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        v[u][c] = (double)nv[u][c];
        if (key[u] >= 0) mb = max(mb, Fixed<T>::bits(nv[u][c]));
      }
      if (key[u] >= 0) {
        kmin = min(kmin, key[u]);
        kmax = max(kmax, key[u]);
      }
    }
    int ex = Fixed<T>::exponent(mb);
    if (base + 32 * U < q0 + per_warp)  // past q1 it loads no query
      load_batch<T, I, CM>(src, idx, base + 32 * U, q1, ld, c0, nc, nid, nv);

    // the CTA agrees on its scale and rows: rescale and zero, then add
    ex = __reduce_max_sync(kFull, ex);
    kmin = __reduce_min_sync(kFull, kmin);
    kmax = __reduce_max_sync(kFull, kmax);
    if (lane == 0) {
      wexp[warp] = ex;
      wlo[warp] = kmin;
      whi[warp] = kmax;
    }
    __syncthreads();
    int bex = e_max, blo = lo, bhi = hi;
    for (int w = 0; w < kWarps; ++w) {
      bex = max(bex, wexp[w]);
      if (wlo[w] <= whi[w]) {
        blo = min(blo, wlo[w]);
        bhi = max(bhi, whi[w]);
      }
    }
    if (bex > e_max && bex != INT_MAX && e_max != kNone && lo <= hi) {
      const int span = hi - lo + 1;
      for (int k = threadIdx.x; k < span * nc; k += blockDim.x)
        shift_fixed<W>(tab, E, (k / span) * rows + lo + k % span, bex - e_max);
    }
    if (blo < lo || bhi > hi) {
      const bool none = lo > hi;
      const int a1 = none ? bhi + 1 : lo, b0 = none ? bhi + 1 : hi + 1;
      for (int c = 0; c < nc; ++c) {
        for (int r = blo + threadIdx.x; r < a1; r += blockDim.x)
          for (int j = 0; j < W; ++j) tab[j * E + c * rows + r] = 0u;
        for (int r = b0 + threadIdx.x; r <= bhi; r += blockDim.x)
          for (int j = 0; j < W; ++j) tab[j * E + c * rows + r] = 0u;
      }
    }
    e_max = bex;
    lo = blo;
    hi = bhi;
    s = Fixed<T>::kMag - e_max - en;
    __syncthreads();
    if (e_max == INT_MAX) continue;  // a non-finite value: no more adds

#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = key[u];
      const int k0 = __shfl_sync(kFull, k, 0);
      if (__all_sync(kFull, k == k0) && k0 >= 0) {
        // one run fills the round: each lane adds its value to its own sum
        if (k0 != carry) {
          end_carry<W, CM>(tab, rows, nc, s, carry, cacc);
          carry = k0;
        }
#pragma unroll
        for (int c = 0; c < CM; ++c) cacc[c] += v[u][c];
        continue;
      }
      end_carry<W, CM>(tab, rows, nc, s, carry, cacc);
      const int kprev = __shfl_up_sync(kFull, k, 1);
      const int knext = __shfl_down_sync(kFull, k, 1);
      // the segmented inclusive scan, (f, v) <- (f_prev | f, f ? v : v_prev
      // + v), until every lane has reached the head of its run
      int f = (lane == 0 || kprev != k) ? 1 : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        if (__all_sync(kFull, f)) break;
        const int fp = __shfl_up_sync(kFull, f, d);
        double vp[CM];
#pragma unroll
        for (int c = 0; c < CM; ++c) vp[c] = __shfl_up_sync(kFull, v[u][c], d);
        if (lane >= d) {
          if (!f) {
#pragma unroll
            for (int c = 0; c < CM; ++c) v[u][c] = vp[c] + v[u][c];
          }
          f |= fp;
        }
      }
      if (k >= 0 && (lane == 31 || knext != k)) {
#pragma unroll
        for (int c = 0; c < CM; ++c)
          if (c < nc) add_fixed<W>(tab, E, c * rows + k, v[u][c], s);
      }
    }
  }
  if (e_max != INT_MAX) end_carry<W, CM>(tab, rows, nc, s, carry, cacc);
  __syncthreads();

  // 3: the CTA's partial over the rows it touched, as float64
  double* mine = partial + (size_t)blockIdx.x * E;
  const int span = lo <= hi ? hi - lo + 1 : 0;
  const double qnan = __longlong_as_double(0x7ff8000000000000LL);
  for (int k = threadIdx.x; k < span * nc; k += blockDim.x) {
    const int e = (k / span) * rows + lo + k % span;
    mine[e] = e_max == INT_MAX ? qnan : fixed_value<W>(tab, E, e, s);
  }
  if (threadIdx.x == 0) {
    ranges[2 * blockIdx.x] = lo;
    ranges[2 * blockIdx.x + 1] = hi;
  }
  __threadfence();
  __syncthreads();

  // the last CTA of the group sums the group
  const int g = blockIdx.x / kGroup, first = g * kGroup, members = min(kGroup, ctas - first);
  if (threadIdx.x == 0) last = atomicInc(counters + 1 + g, members - 1) == members - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x < 2 * members) wrange[threadIdx.x] = __ldcg(ranges + 2 * first + threadIdx.x);
  __syncthreads();
  const int2 gr = union_range(wrange, members);
  sum_members(partial + (size_t)first * E, wrange, members, rows, nc, gr.x, gr.y,
              partial + (size_t)(ctas + g) * E);
  if (threadIdx.x == 0) {
    ranges[2 * (ctas + g)] = gr.x;
    ranges[2 * (ctas + g) + 1] = gr.y;
  }
  __threadfence();
  __syncthreads();

  // the last group sums the groups, kGroup at a time, and writes out
  if (threadIdx.x == 0) last = atomicInc(counters, groups - 1) == groups - 1;
  __syncthreads();
  if (!last) return;
  const double* gpart = partial + (size_t)ctas * E;
  if (threadIdx.x < 2 * groups) gr_ranges[threadIdx.x] = __ldcg(ranges + 2 * ctas + threadIdx.x);
  __syncthreads();
  for (int k = threadIdx.x; k < E; k += blockDim.x) {
    const int c = k / rows, r = k % rows;
    double total = 0.0;  // kTop groups at a time, the trees' sums in order
    for (int m0 = 0; m0 < groups; m0 += kTop) {
      double v[kTop];
#pragma unroll
      for (int m = 0; m < kTop; ++m)
        v[m] = m0 + m < groups ? __ldcg(gpart + (size_t)(m0 + m) * E + k) : 0.0;
#pragma unroll
      for (int m = 0; m < kTop; ++m)
        if (!(m0 + m < groups && gr_ranges[2 * (m0 + m)] <= r && r <= gr_ranges[2 * (m0 + m) + 1]))
          v[m] = 0.0;
      total = m0 == 0 ? tree_sum(v) : total + tree_sum(v);
    }
    out[(row0 + r) * ld + c0 + c] = (T)total;
  }
}

template <typename T, typename I, int CM>
int launch_chunk(const T* src, const I* idx, long long n, int ld, int c0, int nc, long long r0,
                 int rows, int ctas, long long per_warp, double* partial, int* ranges,
                 unsigned* counters, T* out, cudaStream_t stream) {
  const size_t smem = (size_t)Fixed<T>::W * rows * nc * sizeof(unsigned);
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_sum_kernel<T, I, CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  segment_sum_kernel<T, I, CM><<<ctas, 32 * kWarps, smem, stream>>>(
      src, idx, n, ld, c0, nc, r0, rows, per_warp, partial, ranges, counters, out);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch(const void* src, const void* idx, long long n, int ld, long long R,
           long long row_chunk, int ctas, long long per_warp_cols[4], void* partial,
           void* ranges, void* counters, void* out, cudaStream_t stream) {
  const T* s = static_cast<const T*>(src);
  const I* i = static_cast<const I*>(idx);
  double* p = static_cast<double*>(partial);
  int* rg = static_cast<int*>(ranges);
  unsigned* cnt = static_cast<unsigned*>(counters);
  T* o = static_cast<T*>(out);
  for (int c0 = 0; c0 < ld; c0 += kMaxCols) {
    const int nc = ld - c0 < kMaxCols ? ld - c0 : kMaxCols;
    for (long long r0 = 0; r0 < R; r0 += row_chunk) {
      const int rows = (int)(R - r0 < row_chunk ? R - r0 : row_chunk);
      int err;
      if (nc == 1)
        err = launch_chunk<T, I, 1>(s, i, n, ld, c0, nc, r0, rows, ctas, per_warp_cols[0], p, rg,
                                    cnt, o, stream);
      else if (nc == 2)
        err = launch_chunk<T, I, 2>(s, i, n, ld, c0, nc, r0, rows, ctas, per_warp_cols[1], p, rg,
                                    cnt, o, stream);
      else if (nc <= 4)
        err = launch_chunk<T, I, 4>(s, i, n, ld, c0, nc, r0, rows, ctas, per_warp_cols[2], p, rg,
                                    cnt, o, stream);
      else
        err = launch_chunk<T, I, 8>(s, i, n, ld, c0, nc, r0, rows, ctas, per_warp_cols[3], p, rg,
                                    cnt, o, stream);
      if (err != 0) return err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src (n, ld) float32 or float64 (f64), idx (n,) int32 or int64 (idx64);
// the plan (ops/segment.py::segment_plan): row_chunk rows a launch, ctas
// CTAs of 8 warps a launch, per_warp queries a warp for a launch of 1, 2,
// <= 4 and <= 8 columns; partial and ranges the scratch of one launch
// ((ctas + ceil(ctas / 16)) row_chunk min(ld, 8) doubles, twice as many
// ints), counters 1 + ceil(ctas / 16) words, 0 between launches; out
// (R, ld).
extern "C" int segment_sum(const void* src, const void* idx, long long n, int ld, long long R,
                           int f64, int idx64, long long row_chunk, int ctas, long long pw1,
                           long long pw2, long long pw4, long long pw8, void* partial,
                           void* ranges, void* counters, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  long long pw[4] = {pw1, pw2, pw4, pw8};
  if (f64)
    return idx64 ? launch<double, long long>(src, idx, n, ld, R, row_chunk, ctas, pw, partial,
                                             ranges, counters, out, s)
                 : launch<double, int>(src, idx, n, ld, R, row_chunk, ctas, pw, partial, ranges,
                                       counters, out, s);
  return idx64 ? launch<float, long long>(src, idx, n, ld, R, row_chunk, ctas, pw, partial,
                                          ranges, counters, out, s)
               : launch<float, int>(src, idx, n, ld, R, row_chunk, ctas, pw, partial, ranges,
                                    counters, out, s);
}
