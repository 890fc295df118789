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
// I_x(a, b) = clamp(z, 0, 1), found by ceil(n_iter / 6) rounds of a 64-way
// search on [0, 1], returned as the midpoint of the last bracket.
//
// What they replace: XLA's fusion of jax.scipy.special.betainc inside the
// JAX package's jitted log-probability (bask_tpu/models/warping.py:33-37,
// which "fuses with the Gram construction") and the fori_loop bisection of
// its unwarp (:63-79), one device program each. There is no Pallas kernel.
// Run op by op, the port's plain version launched once per continued-
// fraction term over (48, *x.shape) coefficient tensors, and the unwarp
// ran 10 rounds of that on 63 probes at once.
//
// The function, per entry, is the plain version's (models/warping.py
// betainc) step for step: the x > (a + 1) / (a + b + 2) flip to the
// symmetric side, the front exp(aa log xx + bb log1p(-xx) - betaln(aa, bb)
// - log aa), and the 48-term continued fraction
//   d_{2m+1} = -(aa + m)(aa + bb + m) xx / ((aa + 2m)(aa + 2m + 1))
//   d_{2m}   =  m (bb - m) xx / ((aa + 2m - 1)(aa + 2m))
//   u = 1 + d_1 / (1 + d_2 / (1 + ...)),  I = front / u  (1 - that if flipped)
// summed backward from the tail, each operation in the plain version's
// order. betaln is symmetric in a and b, so it is taken once per column
// (lgamma(a) + lgamma(b) - lgamma(a + b) equals the flipped sum exactly),
// and log a and log b beside it. No approximate intrinsic: logf, log1pf,
// expf, lgammaf and IEEE divisions (the double versions at float64). nvcc
// may contract a multiply and an add into one FMA (its default), so the
// kernels are not bit-equal to the plain version; they are held to it in
// float64 within stated tolerances (chip_smoke.py phase 15).
//
// K7 keeps the plain version's search exactly: the probes of a round are
// lo + width * (k / 64), k = 1..63, in the tensor's type; the count of
// probes whose CDF lies below z moves lo by count * (width / 64), and width
// becomes width / 64 (powers of two, exact). One warp owns one entry: lane l
// evaluates probes l + 1 and l + 33 (lane 31 only the first), __ballot_sync
// and __popc count the votes, and every lane updates the same lo.
//
// What bounds them on an H100: operations. Counted as ops/warp_values.py
// does (k6_operations, k7_operations: what the function needs, a division,
// a log or an exp counted as one), a Beta CDF is 160 operations (3 a term
// once a column's 48 coefficients are made) and moves no byte beyond its
// input and output: at the batch ask's queries, (256, 65,536, 15) from
// shared X, 4.1e10 operations (0.61 ms at 67 TFLOP/s) against 1.0 GB
// written (0.30 ms at 3.35 TB/s); the unwarp of a 65,536 x 15 grid to a
// 2^-60 bracket, 60 bisection steps an entry, 9.6e9 operations (0.14 ms)
// against 7.9 MB. The designs spend more: K6 ~10 operations a term (the
// plain version's, coefficients made per entry) and K7 63 CDFs a round,
// ~3x and ~10x the counts; the divisions and transcendentals are several
// instructions each.
//
// What the designs do about it: nothing but the inputs and the outputs
// reach the card's memory and no coefficient is stored. K6's block gives each thread one
// column (threads = d * floor(256 / d) for d <= 256; past that, groups of
// 256 columns) and walks it over a run of rows,
// so a, b, betaln, log a and log b are computed once per thread and
// column, not per entry; consecutive threads write consecutive entries.
// K7's lanes share the entry's column constants the same way and spend
// every instruction on probes, with no data-dependent branch (a flipped
// and an unflipped probe run the same instructions).

#include <cuda_runtime.h>

namespace {

constexpr int kTerms = 48;        // ops/warp_values.py CF_TERMS
constexpr int kWays = 64;         // ops/warp_values.py WAYS
constexpr int kWarpThreads = 256; // K6: at most this many threads a block
constexpr int kUnwarpWarps = 8;   // K7: warps (entries) a block
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Fn;

template <>
struct Fn<float> {
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float log1p(float x) { return log1pf(x); }
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float lgamma(float x) { return lgammaf(x); }
};

template <>
struct Fn<double> {
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double log1p(double x) { return ::log1p(x); }
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double lgamma(double x) { return ::lgamma(x); }
};

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

// torch.clamp(x, 0, 1): NaN stays NaN (fminf/fmaxf would drop it)
template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

// I_x(a, b) for x in [0, 1]: warping.betainc, operation for operation
template <typename T>
__device__ __forceinline__ T beta_cdf(const Column<T>& c, T x) {
  using F = Fn<T>;
  const bool flip = x > c.flip_at;
  const T aa = flip ? c.b : c.a;
  const T bb = flip ? c.a : c.b;
  const T xx = flip ? T(1) - x : x;
  const T log_front = aa * F::log(xx) + bb * F::log1p(-xx) - c.betaln - (flip ? c.log_b : c.log_a);
  const T apb = aa + bb;
  T u = T(1);
#pragma unroll 8
  for (int k = kTerms; k >= 1; --k) {
    const T m = T(k / 2);
    const T num = (k & 1) ? -(aa + m) * (apb + m) : m * (bb - m);
    const T ak = aa + T(k);
    const T dk = num * xx / ((ak - T(1)) * ak);
    u = T(1) + dk / u;
  }
  const T front = F::exp(log_front) / u;
  return flip ? T(1) - front : front;
}

// the Beta pdf at x in [0, 1], as JAX's betainc derivative in x forms it:
// exp((b - 1) log1p(-x) + (a - 1) log x - betaln(a, b))
template <typename T>
__device__ __forceinline__ T beta_pdf(const Column<T>& c, T x) {
  using F = Fn<T>;
  return F::exp((c.b - T(1)) * F::log1p(-x) + (c.a - T(1)) * F::log(x) - c.betaln);
}

// K6. Block (b, column group g, run of rows): thread t owns column
// g * width + t % width (width = min(d, 256)) and the rows t / width,
// t / width + rows_per_pass, ... of the run.
template <typename T>
__global__ void __launch_bounds__(kWarpThreads)
warp_kernel(const T* __restrict__ X, long long x_batch_stride, const T* __restrict__ la,
            long long la_stride, const T* __restrict__ lb, long long lb_stride,
            T* __restrict__ out, T* __restrict__ pdf, long long n, int d, int width,
            int run_rows, long long runs) {
  const int rows_per_pass = blockDim.x / width;
  const int j = blockIdx.y * width + threadIdx.x % width;
  const int r0 = threadIdx.x / width;
  if (j >= d) return;  // the last column group's threads past d
  const long long b = blockIdx.x / runs;
  const long long first = (blockIdx.x - b * runs) * run_rows;
  const long long last = min(first + run_rows, n);
  const Column<T> c = column(la[b * la_stride + j], lb[b * lb_stride + j]);
  const T* xb = X + b * x_batch_stride;
  T* ob = out + b * n * d;
  T* pb = pdf == nullptr ? nullptr : pdf + b * n * d;
  for (long long i = first + r0; i < last; i += rows_per_pass) {
    const long long e = i * d + j;
    const T x = clamp01(xb[e]);
    ob[e] = beta_cdf(c, x);
    if (pb != nullptr) pb[e] = beta_pdf(c, x);
  }
}

// K7. One warp per entry (b, i, j), entries in row-major order.
template <typename T>
__global__ void __launch_bounds__(kUnwarpWarps * 32)
unwarp_kernel(const T* __restrict__ Z, long long z_batch_stride, const T* __restrict__ la,
              long long la_stride, const T* __restrict__ lb, long long lb_stride,
              T* __restrict__ out, long long n, int d, long long entries, int rounds) {
  const long long e = (long long)blockIdx.x * kUnwarpWarps + threadIdx.x / 32;
  if (e >= entries) return;  // uniform across the warp
  const int lane = threadIdx.x % 32;
  const long long nd = n * d;
  const long long b = e / nd;
  const long long r = e - b * nd;
  const int j = (int)(r % d);
  const Column<T> c = column(la[b * la_stride + j], lb[b * lb_stride + j]);
  const T z = clamp01(Z[b * z_batch_stride + r]);
  const T step1 = T(lane + 1) / T(kWays);   // exact: k / 64
  const T step2 = T(lane + 33) / T(kWays);
  T lo = T(0);
  T width = T(1);
  for (int round = 0; round < rounds; ++round) {
    const bool below1 = beta_cdf(c, lo + width * step1) < z;
    const bool below2 = lane < kWays - 33 && beta_cdf(c, lo + width * step2) < z;
    const int count = __popc(__ballot_sync(kFull, below1)) + __popc(__ballot_sync(kFull, below2));
    lo = lo + T(count) * (width / T(kWays));
    width = width / T(kWays);
  }
  if (lane == 0) out[e] = lo + T(0.5) * width;
}

template <typename T>
int launch_warp(const T* X, long long x_batch_stride, const T* la, long long la_stride,
                const T* lb, long long lb_stride, T* out, T* pdf, int B, long long n, int d,
                void* stream) {
  if (B < 0 || n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  const int width = d < kWarpThreads ? d : kWarpThreads;
  const int groups = (d + width - 1) / width;
  const int rows_per_pass = kWarpThreads / width;
  // passes per block: enough blocks to give each of 132 SMs ~8 of them,
  // at most 64 passes (a thread's column constants serve its passes)
  const long long want = 132LL * 8;
  long long passes = ((long long)B * groups * ((n + rows_per_pass - 1) / rows_per_pass) + want - 1)
                     / want;
  passes = passes < 1 ? 1 : (passes > 64 ? 64 : passes);
  const long long run_rows = passes * rows_per_pass;
  const long long runs = (n + run_rows - 1) / run_rows;
  if (B * runs > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * runs), groups);
  warp_kernel<T><<<grid, rows_per_pass * width, 0, (cudaStream_t)stream>>>(
      X, x_batch_stride, la, la_stride, lb, lb_stride, out, pdf, n, d, width, (int)run_rows,
      runs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_unwarp(const T* Z, long long z_batch_stride, const T* la, long long la_stride,
                  const T* lb, long long lb_stride, T* out, int B, long long n, int d,
                  int rounds, void* stream) {
  if (B < 0 || n < 0 || d < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
  const long long entries = (long long)B * n * d;
  if (entries == 0) return (int)cudaSuccess;
  const long long blocks = (entries + kUnwarpWarps - 1) / kUnwarpWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  unwarp_kernel<T><<<(unsigned)blocks, kUnwarpWarps * 32, 0, (cudaStream_t)stream>>>(
      Z, z_batch_stride, la, la_stride, lb, lb_stride, out, n, d, entries, rounds);
  return (int)cudaGetLastError();
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
// contiguous (B, n, d); rounds = ceil(n_iter / 6).
extern "C" int bask_unwarp_f32(const float* Z, long long z_batch_stride, const float* la,
                               long long la_stride, const float* lb, long long lb_stride,
                               float* out, int B, long long n, int d, int rounds, void* stream) {
  return launch_unwarp<float>(Z, z_batch_stride, la, la_stride, lb, lb_stride, out, B, n, d,
                              rounds, stream);
}

extern "C" int bask_unwarp_f64(const double* Z, long long z_batch_stride, const double* la,
                               long long la_stride, const double* lb, long long lb_stride,
                               double* out, int B, long long n, int d, int rounds,
                               void* stream) {
  return launch_unwarp<double>(Z, z_batch_stride, la, la_stride, lb, lb_stride, out, B, n, d,
                               rounds, stream);
}
