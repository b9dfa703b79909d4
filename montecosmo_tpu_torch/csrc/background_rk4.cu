// K8: the background tables of one cosmology in one launch, each carried
// with its first and second derivatives with respect to Omega_m.
//
// Replaces the two fixed-step RK4 integrations of
// montecosmo_tpu/ops/background.py::Background.create (:148), each a
// lax.scan of _rk4 (:115) that XLA runs as one loop on the device (no
// Pallas kernel): the growth ODE of the first- and second-order growth
// factors, state (g1, g2, d1, d2) = (D1, D2, dD1/da, dD2/da) on the 128
// log-spaced float32 nodes of a in [1e-3, 1], and the comoving-distance
// integral dchi/dln a = RH / (a E(a)) on the 256 nodes of ln a.  Its
// outputs are the raw tables that ops/background.py normalises:
//   out[k][4 n + c]  growth state c at node n (c = g1, g2, d1, d2),
//   out[k][512 + n]  chi at node n, integrated up from a = 1e-3,
// for k = 0 (value), 1 (d/dOmega_m) and 2 (d^2/dOmega_m^2).
//
// Math, in float64: every quantity is a jet (v, v', v'') in Omega_m, with
// Omega_de = 1 - Omega_m - Omega_k the jet (., -1, 0) and the other
// parameters (Omega_k, w0, wa) constants; products, quotients and the
// square root follow Leibniz's rule to second order.  The right-hand sides
// depend on a and on the state: the growth's is (d1, d2, r g1 - q d1,
// r g2 - q d2 - r g1^2) with q(a) and r(a) functions of a alone, the
// distance's a function of a alone.  So the coefficients (q, r) at the 255
// growth abscissae (128 nodes, 127 midpoints) and the distance integrand
// at the 511 distance abscissae are computed first, in parallel (the pow,
// exp, sqrt and divisions; 256 threads, three abscissae each), into shared
// memory.  Then two threads of two warps run the dependent chains at once:
// the growth's 127 RK4 steps (thread 0), whose four stages evaluate the
// state part of the right-hand side only, and the distance's 255 steps
// (thread 32), where k2 = k3 and each step adds h/6 (f0 + 2 fm + 2 fm +
// f1).  The float32 nodes come from the host once per device; the results
// are written as float32 (or float64 for a float64 Omega_m).
//
// What bounds it on an H100: not bytes (9 KB out) nor operations (~10^5
// FP64), but the latency of the growth's dependent chain: 127 steps of a
// few dozen dependent FP64 operations each.  Omega_m is read from device
// memory (a 0-d float32 or float64 tensor), so nothing syncs with the host.
//
// Plain C interface, loaded with ctypes; the entry point returns
// cudaGetLastError() of its launch.  fp64_chain is the yardstick of the
// bound: one thread making n dependent FP64 FMAs.
#include <cuda_runtime.h>

namespace {

constexpr int kGrowthN = 128;               // growth nodes (ops/background.py GROWTH_STEPS)
constexpr int kDistN = 256;                 // distance nodes (DIST_STEPS)
constexpr int kGrowthPts = 2 * kGrowthN - 1;  // nodes and midpoints
constexpr int kDistPts = 2 * kDistN - 1;
// one CTA; the chain threads keep ~100 doubles live, so at most 256 threads
// (255 registers a thread), each computing ~3 of the 766 abscissae
constexpr int kThreads = 256;
constexpr double kRH = 2997.92458;          // c / (100 km/s/Mpc), Mpc/h

// A value and its first and second derivatives in Omega_m.
struct Jet {
  double v, d, dd;
};

__device__ __forceinline__ Jet operator+(Jet a, Jet b) { return {a.v + b.v, a.d + b.d, a.dd + b.dd}; }
__device__ __forceinline__ Jet operator-(Jet a, Jet b) { return {a.v - b.v, a.d - b.d, a.dd - b.dd}; }
__device__ __forceinline__ Jet operator*(double s, Jet a) { return {s * a.v, s * a.d, s * a.dd}; }
__device__ __forceinline__ Jet operator*(Jet a, Jet b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d, a.dd * b.v + 2.0 * a.d * b.d + a.v * b.dd};
}
__device__ __forceinline__ Jet operator/(Jet a, Jet b) {
  const double q = a.v / b.v;
  const double q1 = (a.d - q * b.d) / b.v;
  return {q, q1, (a.dd - 2.0 * q1 * b.d - q * b.dd) / b.v};
}
__device__ __forceinline__ Jet jsqrt(Jet a) {
  const double s = sqrt(a.v);
  const double s1 = a.d / (2.0 * s);
  return {s, s1, (a.dd - 2.0 * s1 * s1) / (2.0 * s)};
}
// y + s x
__device__ __forceinline__ Jet axpy(double s, Jet x, Jet y) {
  return {fma(s, x.v, y.v), fma(s, x.d, y.d), fma(s, x.dd, y.dd)};
}

struct Params {
  double ok, w0, wa;
};

// E^2(a) = Omega_m a^-3 + Omega_k a^-2 + Omega_de f_de(a), and its two
// terms Omega_m a^-3 and Omega_de f_de(a), as jets.
__device__ __forceinline__ void esqr(double a, double om, const Params& c, Jet& e2, Jet& m,
                                     Jet& de) {
  const double a3 = 1.0 / (a * a * a);
  const double fde = pow(a, -3.0 * (1.0 + c.w0 + c.wa)) * exp(-3.0 * c.wa * (1.0 - a));
  m = Jet{om * a3, a3, 0.0};
  de = Jet{(1.0 - om - c.ok) * fde, -fde, 0.0};
  e2 = m + de + Jet{c.ok / (a * a), 0.0, 0.0};
}

// The growth ODE's coefficients at a: q = (2 - (Omega_m(a) + (1 + 3 w(a))
// Omega_de(a)) / 2) / a and r = 3/2 Omega_m(a) / a^2.
__device__ __forceinline__ void growth_coeffs(double a, double om, const Params& c, Jet& q,
                                              Jet& r) {
  Jet e2, m, de;
  esqr(a, om, c, e2, m, de);
  const Jet om_a = m / e2, ode_a = de / e2;
  const double w = c.w0 + c.wa * (1.0 - a);
  q = (1.0 / a) * (Jet{2.0, 0.0, 0.0} - 0.5 * (om_a + (1.0 + 3.0 * w) * ode_a));
  r = (1.5 / (a * a)) * om_a;
}

// The distance integrand RH / (a E(a)) at ln a.
__device__ __forceinline__ Jet dchi(double lna, double om, const Params& c) {
  const double a = exp(lna);
  Jet e2, m, de;
  esqr(a, om, c, e2, m, de);
  return Jet{kRH / a, 0.0, 0.0} / jsqrt(e2);
}

// The growth right-hand side at state y with coefficients (q, r).
__device__ __forceinline__ void growth_rhs(const Jet (&y)[4], const Jet& q, const Jet& r,
                                           Jet (&k)[4]) {
  const Jet rg1 = r * y[0];
  k[0] = y[2];
  k[1] = y[3];
  k[2] = rg1 - q * y[2];
  k[3] = r * y[1] - q * y[3] - rg1 * y[0];
}

template <class T>
__device__ __forceinline__ void put(T* const (&out)[3], int i, const Jet& x) {
  out[0][i] = (T)x.v;
  out[1][i] = (T)x.d;
  out[2][i] = (T)x.dd;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    background_tables_kernel(const float* __restrict__ atab, const float* __restrict__ lna,
                             const void* om_p, int om_f64, Params c, T* v, T* d, T* dd) {
  __shared__ Jet qs[kGrowthPts], rs[kGrowthPts], fs[kDistPts];
  T* const out[3] = {v, d, dd};
  const double om = om_f64 ? *static_cast<const double*>(om_p)
                           : (double)*static_cast<const float*>(om_p);
  const int i = threadIdx.x;
  // abscissa 2n is node n, 2n + 1 the midpoint of step n
  for (int j = i; j < kGrowthPts + kDistPts; j += blockDim.x) {
    if (j < kGrowthPts) {
      const double t0 = atab[j / 2];
      const double a = j % 2 ? t0 + 0.5 * ((double)atab[j / 2 + 1] - t0) : t0;
      growth_coeffs(a, om, c, qs[j], rs[j]);
    } else {
      const int l = j - kGrowthPts;
      const double t0 = lna[l / 2];
      fs[l] = dchi(l % 2 ? t0 + 0.5 * ((double)lna[l / 2 + 1] - t0) : t0, om, c);
    }
  }
  __syncthreads();
  if (i == 0) {
    const double a0 = atab[0];
    Jet y[4] = {{a0, 0.0, 0.0}, {-3.0 / 7.0 * a0 * a0, 0.0, 0.0}, {1.0, 0.0, 0.0},
                {-6.0 / 7.0 * a0, 0.0, 0.0}};
    for (int ch = 0; ch < 4; ++ch) put(out, ch, y[ch]);
    for (int n = 0; n < kGrowthN - 1; ++n) {
      const double h = (double)atab[n + 1] - (double)atab[n];
      // k1 + 2 k2 + 2 k3 + k4 summed as the stages come, left to right
      Jet k[4], acc[4], yt[4];
      growth_rhs(y, qs[2 * n], rs[2 * n], k);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        acc[ch] = k[ch];
        yt[ch] = axpy(0.5 * h, k[ch], y[ch]);
      }
      growth_rhs(yt, qs[2 * n + 1], rs[2 * n + 1], k);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        acc[ch] = acc[ch] + 2.0 * k[ch];
        yt[ch] = axpy(0.5 * h, k[ch], y[ch]);
      }
      growth_rhs(yt, qs[2 * n + 1], rs[2 * n + 1], k);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        acc[ch] = acc[ch] + 2.0 * k[ch];
        yt[ch] = axpy(h, k[ch], y[ch]);
      }
      growth_rhs(yt, qs[2 * n + 2], rs[2 * n + 2], k);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        y[ch] = y[ch] + (h / 6.0) * (acc[ch] + k[ch]);
        put(out, 4 * (n + 1) + ch, y[ch]);
      }
    }
  } else if (i == 32) {
    Jet chi{0.0, 0.0, 0.0};
    put(out, 4 * kGrowthN, chi);
    for (int n = 0; n < kDistN - 1; ++n) {
      const double h = (double)lna[n + 1] - (double)lna[n];
      const Jet fm = fs[2 * n + 1];
      chi = chi + (h / 6.0) * (fs[2 * n] + 2.0 * fm + 2.0 * fm + fs[2 * n + 2]);
      put(out, 4 * kGrowthN + n + 1, chi);
    }
  }
}

__global__ void fp64_chain_kernel(long long n, double x, double* out) {
  double y = x;
  for (long long i = 0; i < n; ++i) y = fma(y, x, 0.5);
  *out = y;
}

}  // namespace

extern "C" int background_tables(const float* atab, const float* lna, const void* om, int om_f64,
                                 double ok, double w0, double wa, void* v, void* d, void* dd,
                                 int out_f64, void* stream) {
  const Params c{ok, w0, wa};
  if (out_f64)
    background_tables_kernel<double><<<1, kThreads, 0, (cudaStream_t)stream>>>(
        atab, lna, om, om_f64, c, (double*)v, (double*)d, (double*)dd);
  else
    background_tables_kernel<float><<<1, kThreads, 0, (cudaStream_t)stream>>>(
        atab, lna, om, om_f64, c, (float*)v, (float*)d, (float*)dd);
  return (int)cudaGetLastError();
}

// n dependent FP64 FMAs in one thread (the latency of the growth's chain).
extern "C" int fp64_chain(long long n, double x, double* out, void* stream) {
  fp64_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(n, x, out);
  return (int)cudaGetLastError();
}
