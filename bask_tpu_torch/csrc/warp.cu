// K6 and K7: the Beta-CDF input warp and its inverse, float32 and float64.
//
// K6 computes models/warping.warp's function,
//
//   out[b, i, j] = I_x(a_bj, b_bj),  x = clamp(X[b, i, j], 0, 1),
//   a_bj = exp(log_alphas[b, j]),  b_bj = exp(log_betas[b, j]),
//
// X (n, d) shared by every row or (B, n, d) one per row, and optionally the
// Beta pdf at the clamped x (the derivative JAX's betainc has in x, for
// the backward). K7 computes models/warping.unwarp's function: the x with
// I_x(a, b) = clamp(z, 0, 1), by bisection over the type's ordered bit
// patterns of [0, 1] (30 steps at float32, 62 at float64 end on two
// adjacent representable x), returned as the end whose CDF lies nearer z.
//
// What they replace: XLA's fusion of jax.scipy.special.betainc inside the
// JAX package's jitted log-probability (bask_tpu/models/warping.py:33-37,
// which "fuses with the Gram construction") and the fori_loop bisection of
// its unwarp (:63-79), one device program each. There is no Pallas kernel.
//
// The function, per entry, is the plain version's (ops/warp_values.py
// betainc): the x > (a + 1) / (a + b + 2) flip to the symmetric side
// (aa, bb, xx) = (b, a, 1 - x), the front exp(aa log xx + bb log1p(-xx) -
// betaln(a, b) - log aa), and the 48-term continued fraction
//   d_k = c_k xx,  c_{2m+1} = -(aa + m)(aa + bb + m) / ((aa + 2m)(aa + 2m + 1)),
//                  c_{2m}   =  m (bb - m) / ((aa + 2m - 1)(aa + 2m)),
//   u = 1 + d_1 / (1 + d_2 / (1 + ...)),  I = front / u  (1 - that if flipped),
// summed from the tail. The plain version makes c_k per entry and divides
// twice a term (u = 1 + d_k / u). Here u is carried as a ratio P / Q: from
// P = Q = 1 at the tail, each term is (P, Q) <- (P + (c_k xx) Q, P), one
// multiply and one FMA, and 1 / u = Q / P is one division at the end. Over
// a, b in [0.01, 100] |log2 P| stays below 80, inside float32's exponent
// range, so no rescaling is needed (tests/test_torch_warp_kernels.py
// holds that). The front takes log x and log1p(-x) of the clamped x on
// either side (aa log xx + bb log1p(-xx) is a log x + b log1p(-x) both
// ways), and the pdf, exp((a - 1) log x + (b - 1) log1p(-x) - betaln),
// reuses them. No approximate intrinsic: logf, log1pf, expf, lgammaf and
// IEEE divisions (the double versions at float64). The kernels are not
// bit-equal to the plain version; they are held to it in float64 within
// stated tolerances (chip_smoke.py phase 15, tests/test_torch_cuda.py).
//
// K7 is a bisection on the bit patterns: a non-negative float's pattern,
// read as an unsigned integer, grows with its value, so [0, 1] is the
// integers [0, bits(1)], and halving that range halves the count of
// representable x in the bracket, whatever their scale. lo = bits(0), hi =
// bits(1); each step probes mid = lo + (hi - lo) / 2 and keeps it as lo
// where the CDF there lies below z, else as hi, and keeps the CDF at both
// ends. Where a or b is well below 1 the CDF is steep at an end (a = 0.03
// maps z up to 0.3 below 2^-60), and a bisection of [0, 1] by halving
// its width stops at its last width there; this one reaches the smallest
// subnormal. The plain version (ops/warp_values.py unwarp_plain) runs the
// same steps op by op; where rounding makes a CDF non-monotone the two
// may part by a step, so K7 is held to the float64 root within a limit
// (x within UNWARP_TOL of it, or its float64 CDF within WARP_TOL of z).
//
// What bounds them on an H100: operations. Counted as
// scripts/kernel_costs.py does (what the function needs, a division, a
// log or an exp counted as one), a Beta CDF is 160 operations (3 a term
// once a column's 48 coefficients are made) and moves no byte beyond its
// input and output: at the batch ask's queries, (256, 65,536, 15) from
// shared X, 4.1e10 operations (0.61 ms at 67 TFLOP/s) against 1.0 GB
// written (0.30 ms at 3.35 TB/s); the unwarp of a 65,536 x 15 grid, 30
// bisection steps an entry at float32, 4.8e9 operations (0.07 ms) against
// 7.9 MB.
//
// What the designs do about it. The coefficients c_k depend on the
// column's (a, b) and the side of the flip only, never on x: each block
// serves one row b and a group of at most 32 columns, and at its start
// its threads write the group's column constants (a, b, the flip point,
// betaln, log a, log b) and both sides' 48 coefficients into static shared
// memory (48 x 32 pairs, 12.3 KB at float32, 24.6 KB at float64), term
// major at a fixed stride, so that the threads of a warp, on consecutive
// columns, read consecutive pairs at immediate offsets. A term then costs
// an entry one select of its side's coefficient, one multiply and one FMA.
// Each thread owns one column over a run of rows and carries R entries of
// it through the fraction at once (4, in K6 and K7), reading each term's
// pair of coefficients with one shared load for all R: one load a term an
// entry would make the shared-memory pipe (32 words a clock) the limit
// instead of the FP32 pipes (128 lanes a clock), and the R independent
// chains hide the FMA's latency. The fraction is unrolled 8 terms at a
// time, and a thread takes 50-64 registers at float32 (4 blocks of 256
// threads an SM): unrolled whole, the compiler loads all 48 pairs ahead
// and a thread took 128-154 registers, one or two blocks an SM, up to 1.3x
// slower (scripts/warp_ab.py, PERF.md). K7 runs one thread per entry's
// bisection, 30 CDFs an entry at float32, the count its bound assumes.
// Where the grid is too small to fill the card (the north-star tell's
// 500 x 15, 7,500 entries) K7 waits on the latency of its 30 dependent
// steps: there each thread carries one entry, the
// fraction is unrolled whole, and blocks shrink below 256 threads so that
// every SM gets some. Nothing but the inputs and the outputs reaches the
// card's memory.

#include <cuda_runtime.h>

namespace {

constexpr int kTerms = 48;     // ops/warp_values.py CF_TERMS
constexpr int kThreads = 256;  // at most this many threads a block
constexpr int kMaxWidth = 32;  // at most this many columns a block
constexpr int kSMs = 132;      // an H100 SXM's SMs, for the launch plan
// entries a thread carries (K6; K7 where its grid fills the card)
constexpr int kK6Entries = 4;
constexpr int kK7Entries = 4;
// terms of the fraction unrolled together: a full unroll lets the compiler
// load all 48 pairs ahead, at 2 registers a pair (4 at float64)
constexpr int kUnroll = 8;
// scripts/warp_ab.py times other values of these three in turns

template <typename T>
struct Fn;

template <>
struct Fn<float> {
  using Pair = float2;
  using Bits = unsigned int;
  static __device__ __forceinline__ Bits one_bits() { return 0x3F800000u; }  // 1.0f
  static __device__ __forceinline__ float from_bits(Bits i) { return __uint_as_float(i); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float log1p(float x) { return log1pf(x); }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float lgamma(float x) { return lgammaf(x); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
};

template <>
struct Fn<double> {
  using Pair = double2;
  using Bits = unsigned long long;
  static __device__ __forceinline__ Bits one_bits() { return 0x3FF0000000000000ull; }  // 1.0
  static __device__ __forceinline__ double from_bits(Bits i) {
    return __longlong_as_double((long long)i);
  }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double log1p(double x) { return ::log1p(x); }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double lgamma(double x) { return ::lgamma(x); }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return ::fma(a, b, c);
  }
};

template <typename T>
using Pair = typename Fn<T>::Pair;  // .x unflipped, .y flipped

// what a column's (a, b) give every entry of the column
template <typename T>
struct Column {
  T a, b, flip_at, betaln, log_a, log_b;
};

template <typename T>
__device__ __forceinline__ Column<T> column(T log_alpha, T log_beta) {
  using F = Fn<T>;
  Column<T> c;
  c.a = F::exp(log_alpha);
  c.b = F::exp(log_beta);
  c.flip_at = (c.a + T(1)) / (c.a + c.b + T(2));
  c.betaln = F::lgamma(c.a) + F::lgamma(c.b) - F::lgamma(c.a + c.b);
  c.log_a = F::log(c.a);
  c.log_b = F::log(c.b);
  return c;
}

// c_k of the side (aa, bb), k = 1..48: d_k / xx of the plain version
template <typename T>
__device__ __forceinline__ T coefficient(T aa, T bb, int k) {
  const T m = T(k / 2);
  const T num = (k & 1) ? -(aa + m) * ((aa + bb) + m) : m * (bb - m);
  const T ak = aa + T(k);
  return num / ((ak - T(1)) * ak);
}

// torch.clamp(x, 0, 1): NaN stays NaN (fminf/fmaxf would drop it)
template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

// The block's tables: the constants of columns j0 .. j0 + width - 1 of
// row b (those below d) and their coefficients, coef[(k - 1) * kMaxWidth +
// c] = (c_k unflipped, c_k flipped) (a fixed stride, so that a term's
// address is an immediate offset). Every thread of the block takes part.
template <typename T>
__device__ __forceinline__ void build_tables(const T* __restrict__ la, const T* __restrict__ lb,
                                             int j0, int width, int d, Column<T>* cols,
                                             Pair<T>* coef) {
  for (int c = threadIdx.x; c < width; c += blockDim.x)
    if (j0 + c < d) cols[c] = column(la[j0 + c], lb[j0 + c]);
  __syncthreads();
  for (int t = threadIdx.x; t < kTerms * width; t += blockDim.x) {
    const int c = t % width;
    if (j0 + c >= d) continue;
    const int k = t / width + 1;
    const T a = cols[c].a, b = cols[c].b;
    Pair<T> p;
    p.x = coefficient(a, b, k);
    p.y = coefficient(b, a, k);
    coef[(k - 1) * kMaxWidth + c] = p;
  }
  __syncthreads();
}

// 1 / u of the continued fraction at R entries of one column (coef: the
// column's first pair): (P, Q) from the tail, one division. One entry a
// thread (K7 on a grid too small to fill the card) waits on the latency of
// its dependent terms, so there all 48 are unrolled.
template <typename T, int R>
__device__ __forceinline__ void inverse_fraction(const Pair<T>* coef, const bool (&flip)[R],
                                                 const T (&xx)[R], T (&inv_u)[R]) {
  T P[R], Q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) P[r] = Q[r] = T(1);
#pragma unroll (R == 1 ? kTerms : kUnroll)
  for (int k = kTerms - 1; k >= 0; --k) {
    const Pair<T> ck = coef[k * kMaxWidth];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T t = (flip[r] ? ck.y : ck.x) * xx[r];
      const T p = Fn<T>::fma(t, Q[r], P[r]);
      Q[r] = P[r];
      P[r] = p;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) inv_u[r] = Q[r] / P[r];
}

// I_x(a, b) at R entries x in [0, 1] of one column, and their log x and
// log1p(-x) (for the pdf)
template <typename T, int R>
__device__ __forceinline__ void beta_cdf(const Column<T>& c, const Pair<T>* coef,
                                         const T (&x)[R], T (&cdf)[R], T (&lx)[R],
                                         T (&l1x)[R]) {
  using F = Fn<T>;
  bool flip[R];
  T xx[R], inv_u[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    flip[r] = x[r] > c.flip_at;
    xx[r] = flip[r] ? T(1) - x[r] : x[r];
  }
  inverse_fraction<T, R>(coef, flip, xx, inv_u);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lx[r] = F::log(x[r]);
    l1x[r] = F::log1p(-x[r]);
    const T log_front =
        c.a * lx[r] + c.b * l1x[r] - c.betaln - (flip[r] ? c.log_b : c.log_a);
    const T front = F::exp(log_front) * inv_u[r];
    cdf[r] = flip[r] ? T(1) - front : front;
  }
}

// K6. Block (b, column group g, run of rows): after the tables, thread t
// owns column g * width + t % width and the rows t / width + q *
// rows_per_pass of the run, R at a time (q, q + 1, ..., q + R - 1).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ X, long long x_batch_stride, const T* __restrict__ la,
            long long la_stride, const T* __restrict__ lb, long long lb_stride,
            T* __restrict__ out, T* __restrict__ pdf, long long n, int d, int width,
            long long run_rows, long long runs) {
  __shared__ Column<T> cols[kMaxWidth];
  __shared__ Pair<T> coef[kTerms * kMaxWidth];
  const long long b = blockIdx.x / runs;
  const int j0 = blockIdx.y * width;
  build_tables(la + b * la_stride, lb + b * lb_stride, j0, width, d, cols, coef);
  const int c = threadIdx.x % width;
  const int j = j0 + c;
  if (j >= d) return;  // the last column group's threads past d
  const int rows_per_pass = blockDim.x / width;
  const long long first = (blockIdx.x - b * runs) * run_rows;
  const long long last = min(first + run_rows, n);
  const Column<T> col = cols[c];
  const T* xb = X + b * x_batch_stride;
  T* ob = out + b * n * d;
  T* pb = pdf == nullptr ? nullptr : pdf + b * n * d;
  for (long long i0 = first + threadIdx.x / width; i0 < last;
       i0 += (long long)R * rows_per_pass) {
    T x[R], cdf[R], lx[R], l1x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = i0 + (long long)r * rows_per_pass;
      x[r] = i < last ? clamp01(xb[i * d + j]) : T(0);
    }
    beta_cdf<T, R>(col, coef + c, x, cdf, lx, l1x);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = i0 + (long long)r * rows_per_pass;
      if (i >= last) break;
      ob[i * d + j] = cdf[r];
      if (pb != nullptr)
        pb[i * d + j] =
            Fn<T>::exp((col.a - T(1)) * lx[r] + (col.b - T(1)) * l1x[r] - col.betaln);
    }
  }
}

// K7. The blocks and threads of K6 over Z; each of a thread's R entries
// bisects on its own bracket of bit patterns, the R CDFs of a step taken
// together. A NaN z stays NaN.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
unwarp_kernel(const T* __restrict__ Z, long long z_batch_stride, const T* __restrict__ la,
              long long la_stride, const T* __restrict__ lb, long long lb_stride,
              T* __restrict__ out, long long n, int d, int width, long long run_rows,
              long long runs, int steps) {
  __shared__ Column<T> cols[kMaxWidth];
  __shared__ Pair<T> coef[kTerms * kMaxWidth];
  const long long b = blockIdx.x / runs;
  const int j0 = blockIdx.y * width;
  build_tables(la + b * la_stride, lb + b * lb_stride, j0, width, d, cols, coef);
  const int c = threadIdx.x % width;
  const int j = j0 + c;
  if (j >= d) return;
  const int rows_per_pass = blockDim.x / width;
  const long long first = (blockIdx.x - b * runs) * run_rows;
  const long long last = min(first + run_rows, n);
  const Column<T> col = cols[c];
  const T* zb = Z + b * z_batch_stride;
  T* ob = out + b * n * d;
  for (long long i0 = first + threadIdx.x / width; i0 < last;
       i0 += (long long)R * rows_per_pass) {
    using Bits = typename Fn<T>::Bits;
    T z[R], cdf_lo[R], cdf_hi[R];
    Bits lo[R], hi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = i0 + (long long)r * rows_per_pass;
      z[r] = i < last ? clamp01(zb[i * d + j]) : T(0);
      lo[r] = 0;
      hi[r] = Fn<T>::one_bits();
      cdf_lo[r] = T(0);
      cdf_hi[r] = T(1);
    }
    for (int s = 0; s < steps; ++s) {
      Bits m[R];
      T mid[R], cdf[R], lx[R], l1x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = lo[r] + ((hi[r] - lo[r]) >> 1);
        mid[r] = Fn<T>::from_bits(m[r]);
      }
      beta_cdf<T, R>(col, coef + c, mid, cdf, lx, l1x);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool below = cdf[r] < z[r];
        lo[r] = below ? m[r] : lo[r];
        cdf_lo[r] = below ? cdf[r] : cdf_lo[r];
        hi[r] = below ? hi[r] : m[r];
        cdf_hi[r] = below ? cdf_hi[r] : cdf[r];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = i0 + (long long)r * rows_per_pass;
      if (i >= last) break;
      const Bits x = z[r] - cdf_lo[r] <= cdf_hi[r] - z[r] ? lo[r] : hi[r];
      ob[i * d + j] = z[r] != z[r] ? z[r] : Fn<T>::from_bits(x);
    }
  }
}

// The launch plan of both kernels for R entries a thread: column groups of
// at most kMaxWidth columns (as even as d allows), rows_per_pass rows of a
// group a pass (a full block, or fewer where full blocks would give fewer
// than 2 an SM), and runs of passes: ~8 blocks an SM, at most 64 passes a
// block (its tables serve its passes).
struct Plan {
  int width, groups, rows_per_pass;
  long long run_rows, runs;
};

inline Plan plan_for(int B, long long n, int d, int R) {
  Plan p;
  p.groups = (d + kMaxWidth - 1) / kMaxWidth;
  p.width = (d + p.groups - 1) / p.groups;
  p.rows_per_pass = kThreads / p.width;
  const long long rows = (long long)B * p.groups * n;
  const long long fill = (rows + 2LL * kSMs * R - 1) / (2LL * kSMs * R);
  if (fill < p.rows_per_pass) p.rows_per_pass = fill < 1 ? 1 : (int)fill;
  const long long pass_rows = (long long)p.rows_per_pass * R;
  const long long want = kSMs * 8LL;
  long long passes = ((long long)B * p.groups * ((n + pass_rows - 1) / pass_rows) + want - 1)
                     / want;
  passes = passes < 1 ? 1 : (passes > 64 ? 64 : passes);
  p.run_rows = passes * pass_rows;
  p.runs = (n + p.run_rows - 1) / p.run_rows;
  return p;
}

inline bool plan_fits(int B, const Plan& p) {
  return (long long)B * p.runs <= 0x7fffffffLL && p.groups <= 65535;
}

template <typename T>
int launch_warp(const T* X, long long x_batch_stride, const T* la, long long la_stride,
                const T* lb, long long lb_stride, T* out, T* pdf, int B, long long n, int d,
                void* stream) {
  if (B < 0 || n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  const Plan p = plan_for(B, n, d, kK6Entries);
  if (!plan_fits(B, p)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * p.runs), p.groups);
  warp_kernel<T, kK6Entries><<<grid, p.rows_per_pass * p.width, 0, (cudaStream_t)stream>>>(
      X, x_batch_stride, la, la_stride, lb, lb_stride, out, pdf, n, d, p.width, p.run_rows,
      p.runs);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_unwarp_r(const T* Z, long long z_batch_stride, const T* la, long long la_stride,
                    const T* lb, long long lb_stride, T* out, int B, long long n, int d,
                    int steps, const Plan& p, cudaStream_t stream) {
  if (!plan_fits(B, p)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * p.runs), p.groups);
  unwarp_kernel<T, R><<<grid, p.rows_per_pass * p.width, 0, stream>>>(
      Z, z_batch_stride, la, la_stride, lb, lb_stride, out, n, d, p.width, p.run_rows, p.runs,
      steps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_unwarp(const T* Z, long long z_batch_stride, const T* la, long long la_stride,
                  const T* lb, long long lb_stride, T* out, int B, long long n, int d,
                  int steps, void* stream) {
  if (B < 0 || n < 0 || d < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  // kK7Entries entries a thread where full blocks of them still give 2
  // blocks an SM (the plan keeps its blocks whole); one where the grid is
  // smaller (there the card waits on latency, and more threads with one
  // entry each finish sooner)
  const Plan wide = plan_for(B, n, d, kK7Entries);
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide.rows_per_pass == kThreads / wide.width)
    return launch_unwarp_r<T, kK7Entries>(Z, z_batch_stride, la, la_stride, lb, lb_stride, out,
                                         B, n, d, steps, wide, s);
  return launch_unwarp_r<T, 1>(Z, z_batch_stride, la, la_stride, lb, lb_stride, out, B, n, d,
                               steps, plan_for(B, n, d, 1), s);
}

}  // namespace

// K6. X is (B, n, d) with x_batch_stride n * d, or (n, d) shared with
// stride 0, rows contiguous; log_alphas and log_betas (B, d) with the given
// row strides (0 for one row shared by all), unit column stride; out and
// pdf (pdf may be null) contiguous (B, n, d).
extern "C" int bask_warp_f32(const float* X, long long x_batch_stride, const float* la,
                             long long la_stride, const float* lb, long long lb_stride,
                             float* out, float* pdf, int B, long long n, int d, void* stream) {
  return launch_warp<float>(X, x_batch_stride, la, la_stride, lb, lb_stride, out, pdf, B, n, d,
                            stream);
}

extern "C" int bask_warp_f64(const double* X, long long x_batch_stride, const double* la,
                             long long la_stride, const double* lb, long long lb_stride,
                             double* out, double* pdf, int B, long long n, int d, void* stream) {
  return launch_warp<double>(X, x_batch_stride, la, la_stride, lb, lb_stride, out, pdf, B, n, d,
                             stream);
}

// K7. Z and the log-parameters as K6's X and log-parameters; out
// contiguous (B, n, d); steps bisection steps over the bit patterns (30
// at float32 and 62 at float64 reach adjacent representable x).
extern "C" int bask_unwarp_f32(const float* Z, long long z_batch_stride, const float* la,
                               long long la_stride, const float* lb, long long lb_stride,
                               float* out, int B, long long n, int d, int steps, void* stream) {
  return launch_unwarp<float>(Z, z_batch_stride, la, la_stride, lb, lb_stride, out, B, n, d,
                              steps, stream);
}

extern "C" int bask_unwarp_f64(const double* Z, long long z_batch_stride, const double* la,
                               long long la_stride, const double* lb, long long lb_stride,
                               double* out, int B, long long n, int d, int steps,
                               void* stream) {
  return launch_unwarp<double>(Z, z_batch_stride, la, la_stride, lb, lb_stride, out, B, n, d,
                               steps, stream);
}
