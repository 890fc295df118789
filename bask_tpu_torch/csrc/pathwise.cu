// K5: the values of pathwise GP draws, float32, for a batch of rows.
//
// For row b, query i and column r (ops/pathwise_values.py has the plain
// version and the source note):
//
//   out[b, i, r] = coef[b] * sum_j W[b, j, r] cos(<Xq[b, i], Om[b, j]> + ph[b, j])
//                + amp[b]  * sum_j V[b, j, r] k_nu(sum_k ((Xq[b,i,k] - X[b,j,k]) ils[b,k])^2)
//
// It replaces the fusion XLA makes inside the JAX package's jitted
// pathwise program (bask_tpu/models/pathwise.py, pathwise_samples and the
// scan of pathwise_topk_hyper): the (rows, queries, features) and (rows,
// queries, training points) intermediates never reach device memory.
//
// What bounds it on an H100: arithmetic. Per (query, feature) pair a
// d-long dot, the cosine and a multiply-add; per (query, training point)
// pair a d-long distance, the Matern (a root and an exponential) and a
// multiply-add (ops/pathwise_values.py: k5_operations counts all of it on
// the FP32 pipes, k5_operations_split puts the 2d of the dots on the
// tensor cores). At the batch ask's shape (256 rows, 65,536 queries, 1,024
// features, 1,000 real of 1,024 points, d = 15) that is 1.02e12 dot
// operations (2.06 ms at 495 TFLOP/s TF32) and 2.03e11 others (3.03 ms at
// 67 TFLOP/s), against ~0.1 GB of inputs and output; and 5.07e10
// transcendental results (cos, sqrt, exp), ~12 ms on the MUFU at 16 a
// clock per SM, the practical floor of this design.
//
// The tensor-core kernel (pathwise_mma_kernel, d <= 31):
//
// * The depth-d products on the tensor cores in 3xTF32 (mma.sync
//   m16n8k8, gram_common.cuh's split_tf32 / mma_tf32, as K4): a block of 8
//   warps owns 256 queries of one row (128 at d > 15), each warp 2 (1)
//   m-tiles of 16; the queries are the A operand, split into hi and lo
//   once and kept in registers for the whole launch. Depth d pads to 16
//   (2 k-steps) or 32 (4).
// * Features, then training points, stream through shared memory in
//   stages of 64 (8 n-tiles of 8), double-buffered: each thread loads its
//   share of the next stage from global memory (L2) into registers while
//   the warps multiply and finish the current one, then splits it into
//   the other buffer; one block barrier a stage. Within a stage the
//   n-tiles run as a software pipeline: n-tile j + 1's products are issued
//   before n-tile j's epilogue. The products still do not hide behind the
//   epilogues: an mma.sync costs the warp that issues it, and at the batch
//   ask the kernel without them takes ~60 % of its time
//   (scripts/k5_variants.py, PERF.md).
// * Points centred on c = 1/2 in every dimension, the unit box's midpoint
//   (the normalized space in which the optimizer's paths call K5). The
//   centre depends on no input, so a NaN query gives NaN at that query
//   only; finite inputs far from the box keep the tolerance, with more of
//   their features on the float64 argument and more pairs on the
//   difference distance (both below). The features' argument is
//   <q - c, om> + (ph + <c, om>), the second term summed in float64 when
//   the stage is split; the cross term's distance is
//   |q~|^2 + |x~|^2 - 2 <q~, x~> with q~ = (q - c) ils, x~ = (x - c) ils
//   (K4's centring: the rounding of the norms and the dot scales with
//   |q~| |x~|). |q~|^2 is the accumulator's initial value; |x~|^2 rides in
//   the padded dimension d (A = 1 there, B = |x~|^2; B = -2 x~ elsewhere),
//   so the MMA's output is d2. That form rounds to ~2^-21 (|q~|^2 + |x~|^2),
//   which the root of k_1/2 turns into ~2^-10.5 near d2 = 0 (at d = 1,
//   nu = 1/2, lengthscale 0.05 the card missed K5_REL_TOL by 10x): a pair
//   whose d2 is below 1/64 of |q~|^2 + the n-tile's largest |x~|^2 forms it
//   again from differences on the FP32 pipes (almost never at d = 15).
//   Clamped at 0, NaN kept; then gram_common.cuh's matern<kNu>. nu is a
//   template argument: with nu taken at run time (one kernel for all four,
//   its build a minute shorter) the batch ask's launch took 3-6 % longer
//   (PERF.md).
// * The cosine in revolutions: the frequencies are scaled by 1/(2 pi) and
//   the phase reduced to [-1/2, 1/2] revolutions when the stage is split;
//   the MMA accumulates u = ph' + <q - c, om'> from ph'; f = u - rint(u) is
//   exact in float32 (the reduction by 2 pi without a rounding), then
//   cos(2 pi f) on the MUFU (__cosf, ~2^-21 absolute).
// * 3xTF32 carries each operand to ~2^-21, not the 2^-24 of an FFMA chain.
//   A feature whose argument may pass kWideArg for some query of the block
//   (|q - c|max sum_k |om_k|, known when the stage is split) keeps PR 10's
//   path: its argument summed in float64 from the raw q and om and reduced
//   by 2 pi there, then cosf. Each warp splits exactly one n-tile of a
//   stage, so a warp vote flags the n-tiles that hold such a feature; the
//   branch is the same for every thread of the block. A warp computes a
//   wide column's values one a lane (its 32 queries, 16 at d > 15) and
//   shuffles each to the lane whose fragment holds it (element by element
//   in the fragment's own lanes, 8 of 32 lanes would work).
// * The reductions: each accumulator element gets one FFMA per column into
//   its row's partial sums (coef W and amp V scaled in when the stage is
//   split, so one sum serves both terms); a quad shuffle reduces the four
//   threads of a row at the end. A fixed order and no atomics: the draws,
//   and the top-k indices taken from them, are the same from run to run.
//
// d >= 32 keeps PR 10's design (pathwise_values_kernel): one thread per
// query, its coordinates in a column of shared memory, 64-wide tiles read
// as broadcasts on the FP32 pipes, the distance from differences, full
// cosf with the same float64 wide-feature path.
//
// Queries are addressed as xq + b * xq_stride (stride 0: one grid shared by
// every row), training points as x + b * x_stride; x == nullptr leaves the
// cross term out (f0 at the training points).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_common.cuh"

namespace {

constexpr int kMaxR = 8;     // columns a launch
constexpr int kMaxD = 256;   // input dimensions
constexpr int kMmaMaxD = 31; // the tensor-core kernel: one padded dimension spare
// a feature whose argument may exceed this takes the float64 argument:
// below it the tensor cores' argument is within ~2^-21 x 256 ~ 1.2e-4 rad
// (the FP32 kernel's within ~4 x 2^-24 x 256 ~ 6e-5 rad)
constexpr float kWideArg = 256.0f;
constexpr double kTwoPi = 6.283185307179586, kInvTwoPi = 0.15915494309189535;
constexpr float kTwoPiF = 6.2831853071795865f, kInvTwoPiF = 0.15915494309189535f;

struct Args {
  const float* xq;        // (B, m, d), or (m, d) with xq_stride 0
  long long xq_stride;
  const float* omega;     // (B, n_feat, d)
  const float* phase;     // (B, n_feat)
  const float* w;         // (B, n_feat, r)
  const float* coef;      // (B,)
  const float* x;         // (B, n_pts, d), or (n_pts, d) with x_stride 0; or null
  long long x_stride;
  const float* inv_ls;    // (B, d)
  const float* v;         // (B, n_pts, r), the mask folded in
  const float* amp;       // (B,)
  float* out;             // (B, m, r)
  int m, n_feat, n_pts, d, r;
};

// cos(t) for a float64 argument: reduced by 2 pi in float64, then cosf of
// the remainder
__device__ __forceinline__ float cos_reduced(double t) {
  return cosf((float)fma(-kTwoPi, rint(t * kInvTwoPi), t));
}

// cos(ph + <q, row>) with the argument summed in float64 (the products of
// two floats are exact there); q[k * q_step]
__device__ __forceinline__ float cos_wide(const float* q, int q_step, const float* row, int d,
                                          float ph) {
  double t = ph;
  for (int k = 0; k < d; ++k) t = fma((double)q[k * q_step], (double)row[k], t);
  return cos_reduced(t);
}

// ---------------------------------------------------------------------------
// The tensor-core kernel, d <= 31
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 64;        // features or points a stage: kWarps n-tiles
constexpr float kCentre = 0.5f;   // every dimension's centre: the unit box's midpoint
constexpr float kWideRev = kWideArg / 6.2831853071795865f;  // kWideArg in revolutions
// a pair whose tensor-core d2 is below this share of |q~|^2 + max |x~|^2 (the
// n-tile's) has its d2 formed again from differences: the norms-minus-dot
// form rounds to ~2^-21 (|q~|^2 + |x~|^2), which near 0 the root of
// k_1/2 would turn into ~2^-10.5
constexpr float kNearShare = 1.0f / 64.0f;

template <int kD>
struct Shape {
  static constexpr int kSteps = kD / 8;                 // k-steps of 8
  static constexpr int kMT = kD == 16 ? 2 : 1;          // m-tiles of 16 queries a warp
  static constexpr int kQueries = kWarps * 16 * kMT;    // a block's queries
  static constexpr int kStride = kD + 4;                // rows of the operands: the lanes
                                                        // (g, t) of a fragment load read
                                                        // banks kStride g + t, all distinct
  static constexpr int kDpt = kD / 4;                   // dimensions a staging thread
};

template <int kR>
__host__ __device__ constexpr int wv_per_thread() {
  return (kStage * kR + kThreads - 1) / kThreads;
}

// floats of one stage buffer: the B operand's hi and lo, the raw
// frequencies (the float64 path) or the scaled points (the near pairs),
// the reduced and raw phases, the scaled weights, a flag per feature, and
// per n-tile a flag (features) or the largest |x~|^2 (points)
template <int kD, int kR>
__host__ __device__ constexpr int stage_floats() {
  return 2 * kStage * Shape<kD>::kStride + kStage * kD + 3 * kStage + kStage * kR + kStage / 8;
}

template <int kD, int kR>
constexpr size_t mma_smem_bytes() {
  return sizeof(float) * (size_t)(Shape<kD>::kQueries * Shape<kD>::kStride + kD + kWarps +
                                  2 * stage_floats<kD, kR>());
}

template <int kNu, int kD, int kR>
__global__ void __launch_bounds__(kThreads, 2)
pathwise_mma_kernel(const Args a) {
  using S = Shape<kD>;
  constexpr int kSteps = S::kSteps, kMT = S::kMT, kQ = S::kQueries, kStr = S::kStride;
  constexpr int kDpt = S::kDpt, kWv = wv_per_thread<kR>();
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // kQ x kStr: the block's raw queries
  float* ils = qs + kQ * kStr;   // kD: 1/ls, zeros past d (cross term only)
  float* red = ils + kD;         // kWarps
  float* stages = red + kWarps;  // 2 stage buffers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the MMA fragments' group and thread in group
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kQ;
  const int d = a.d;
  const float* xq = a.xq + b * a.xq_stride;
  const bool cross = a.x != nullptr;

  // 1/ls
  for (int k = tid; k < kD; k += kThreads) {
    ils[k] = cross && k < d ? a.inv_ls[(long long)b * d + k] : 0.0f;
  }
  // the block's queries; a row past m copies the last query and stores nothing
  for (int e = tid; e < kQ * kD; e += kThreads) {
    const int row = e / kD, k = e - row * kD;
    qs[row * kStr + k] = k < d ? xq[(long long)min(i0 + row, a.m - 1) * d + k] : 0.0f;
  }
  __syncthreads();
  // the block's largest |q - c|, for the wide-argument test
  float qmax = 0.0f;
  for (int e = tid; e < kQ * d; e += kThreads) {
    const int row = e / d, k = e - row * d;
    qmax = fmaxf(qmax, fabsf(qs[row * kStr + k] - kCentre));  // drops a NaN
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  if (lane == 0) red[warp] = qmax;
  __syncthreads();
  qmax = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) qmax = fmaxf(qmax, red[w]);

  // the A operand, rows of this warp's m-tiles: (q - c) or (q - c) / ls
  // in dimensions k < d, 1 in dimension d (it meets |x~|^2), 0 past it
  const int row_base = warp * 16 * kMT;
  auto a_value = [&](int row, int k, bool scaled) -> float {
    if (k > d) return 0.0f;
    if (k == d) return 1.0f;
    const float c = qs[row * kStr + k] - kCentre;
    return scaled ? c * ils[k] : c;
  };
  auto load_a = [&](uint32_t (&ah)[kMT][kSteps][4], uint32_t (&al)[kMT][kSteps][4],
                    bool scaled) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r0 = row_base + mt * 16 + g;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int k0 = ks * 8 + t;
        split_tf32(a_value(r0, k0, scaled), ah[mt][ks][0], al[mt][ks][0]);
        split_tf32(a_value(r0 + 8, k0, scaled), ah[mt][ks][1], al[mt][ks][1]);
        split_tf32(a_value(r0, k0 + 4, scaled), ah[mt][ks][2], al[mt][ks][2]);
        split_tf32(a_value(r0 + 8, k0 + 4, scaled), ah[mt][ks][3], al[mt][ks][3]);
      }
    }
  };

  // the partial sums of the thread's rows (g and g + 8 of each m-tile)
  float part[kMT][2][kR];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < kR; ++c) part[mt][h][c] = 0.0f;

  // staging: thread tid splits row tid / 4 of a stage, dimensions
  // (tid % 4) kDpt .. + kDpt - 1; each warp thus splits one n-tile
  const int srow = tid >> 2, spart = tid & 3;
  const float* om_b = a.omega + (long long)b * a.n_feat * d;
  const float* ph_b = a.phase + (long long)b * a.n_feat;
  const float* w_b = a.w + (long long)b * a.n_feat * a.r;
  const float* x_b = cross ? a.x + b * a.x_stride : nullptr;
  const float* v_b = cross ? a.v + (long long)b * a.n_pts * a.r : nullptr;
  const float coef = a.coef[b];
  const float amp = cross ? a.amp[b] : 0.0f;
  float pre[kDpt], pre_ph = 0.0f, pre_w[kWv];  // the next stage's raw values
  bool live = false;                            // the thread's staging row is a real one
  auto prefetch = [&](bool feat, int j0) {
    const int cnt = min(kStage, (feat ? a.n_feat : a.n_pts) - j0);
    const float* src = feat ? om_b : x_b;
    const float* wsrc = feat ? w_b : v_b;
    live = srow < cnt;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) {
      const int k = spart * kDpt + i;
      pre[i] = live && k < d ? src[(long long)(j0 + srow) * d + k] : 0.0f;
    }
    pre_ph = feat && live ? ph_b[j0 + srow] : 0.0f;
#pragma unroll
    for (int i = 0; i < kWv; ++i) {
      const int e = tid + i * kThreads, row = e / kR, c = e - row * kR;
      pre_w[i] = e < kStage * kR && row < cnt && c < a.r
                     ? wsrc[(long long)(j0 + row) * a.r + c] : 0.0f;
    }
  };

  struct Buf {
    float *hi, *lo, *raw, *ph, *phr, *wv, *wide, *tw;
  };
  auto buffer = [&](int s) {
    Buf u;
    u.hi = stages + (s & 1) * stage_floats<kD, kR>();
    u.lo = u.hi + kStage * kStr;
    u.raw = u.lo + kStage * kStr;
    u.ph = u.raw + kStage * kD;
    u.phr = u.ph + kStage;
    u.wv = u.phr + kStage;
    u.wide = u.wv + kStage * kR;
    u.tw = u.wide + kStage;
    return u;
  };
  auto put_b = [&](const Buf& u, int k, float x) {
    uint32_t h, l;
    split_tf32(x, h, l);
    u.hi[srow * kStr + k] = __uint_as_float(h);
    u.lo[srow * kStr + k] = __uint_as_float(l);
  };
  // features: om / (2 pi) split; ph' = frac((ph + <c, om>) / (2 pi)) in
  // float64; the wide flags; coef W
  auto split_features = [&](const Buf& u) {
    float sabs = 0.0f;
    double sc = 0.0;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) {
      const int k = spart * kDpt + i;
      const float xr = pre[i] * kInvTwoPiF;
      put_b(u, k, xr);
      u.raw[srow * kD + k] = pre[i];
      sabs += fabsf(xr);
      sc = fma((double)kCentre, (double)pre[i], sc);
    }
    sabs += __shfl_xor_sync(0xffffffffu, sabs, 1);
    sabs += __shfl_xor_sync(0xffffffffu, sabs, 2);
    sc += __shfl_xor_sync(0xffffffffu, sc, 1);
    sc += __shfl_xor_sync(0xffffffffu, sc, 2);
    const bool wide = qmax * sabs > kWideRev;
    if (spart == 0) {
      const double tr = ((double)pre_ph + sc) * kInvTwoPi;
      u.ph[srow] = (float)(tr - rint(tr));
      u.phr[srow] = pre_ph;
      u.wide[srow] = wide ? 1.0f : 0.0f;
    }
    const bool any = __any_sync(0xffffffffu, wide);
    if (lane == 0) u.tw[warp] = any ? 1.0f : 0.0f;
#pragma unroll
    for (int i = 0; i < kWv; ++i) {
      const int e = tid + i * kThreads;
      if (e < kStage * kR) u.wv[e] = coef * pre_w[i];
    }
  };
  // points: -2 x~ split, |x~|^2 in dimension d, x~ itself (for the
  // near pairs) and the n-tile's largest |x~|^2; amp V
  auto split_points = [&](const Buf& u) {
    float nx = 0.0f;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) {
      const int k = spart * kDpt + i;
      const float xs = live && k < d ? (pre[i] - kCentre) * ils[k] : 0.0f;
      nx = fmaf(xs, xs, nx);
      put_b(u, k, -2.0f * xs);
      u.raw[srow * kD + k] = xs;
    }
    nx += __shfl_xor_sync(0xffffffffu, nx, 1);
    nx += __shfl_xor_sync(0xffffffffu, nx, 2);
    if (spart == d / kDpt) put_b(u, d, nx);  // after this thread's own zero there
    float mx = nx;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) u.tw[warp] = mx;
#pragma unroll
    for (int i = 0; i < kWv; ++i) {
      const int e = tid + i * kThreads;
      if (e < kStage * kR) u.wv[e] = amp * pre_w[i];
    }
  };

  // one n-tile's products for this warp's m-tiles: acc starts at init
  auto products = [&](float (&acc)[kMT][4], const Buf& u, int col0,
                      uint32_t (&ah)[kMT][kSteps][4], uint32_t (&al)[kMT][kSteps][4]) {
    uint32_t bh[kSteps][2], bl[kSteps][2];
    const float* hp = u.hi + (col0 + g) * kStr + t;
    const float* lp = u.lo + (col0 + g) * kStr + t;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      bh[ks][0] = __float_as_uint(hp[ks * 8]);
      bh[ks][1] = __float_as_uint(hp[ks * 8 + 4]);
      bl[ks][0] = __float_as_uint(lp[ks * 8]);
      bl[ks][1] = __float_as_uint(lp[ks * 8 + 4]);
    }
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma_tf32(acc[mt], al[mt][ks], bh[ks]);
        mma_tf32(acc[mt], ah[mt][ks], bl[ks]);
        mma_tf32(acc[mt], ah[mt][ks], bh[ks]);
      }
    }
  };
  // element e of an m-tile's accumulator: row g + 8 (e >> 1), column 2t + (e & 1)
  auto reduce_into = [&](float (&val)[kMT][4], const Buf& u, int col0) {
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      const float w0 = u.wv[(col0 + 2 * t) * kR + c], w1 = u.wv[(col0 + 2 * t + 1) * kR + c];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          part[mt][h][c] = fmaf(w0, val[mt][2 * h], part[mt][h][c]);
          part[mt][h][c] = fmaf(w1, val[mt][2 * h + 1], part[mt][h][c]);
        }
      }
    }
  };

  const int n_fs = (a.n_feat + kStage - 1) / kStage;
  const int n_ps = cross ? (a.n_pts + kStage - 1) / kStage : 0;
  int s = 0;  // stages so far: the buffer parity
  if (n_fs > 0) {
    prefetch(true, 0);
  } else if (n_ps > 0) {
    prefetch(false, 0);
  }

  // Each stage's 8 n-tiles run as a software pipeline: the next n-tile's
  // products are issued before this one's epilogue, so the epilogue need
  // not wait for the products' latency.
  auto pipeline = [&](const Buf& u, auto start, auto finish) {
    float acc_a[kMT][4], acc_b[kMT][4];
    start(acc_a, u, 0);
#pragma unroll 1
    for (int nt = 0; nt < kStage / 8; nt += 2) {
      start(acc_b, u, nt + 1);
      finish(acc_a, u, nt);
      if (nt + 2 < kStage / 8) start(acc_a, u, nt + 2);
      finish(acc_b, u, nt + 1);
    }
  };

  // the random features: sum_j coef W[j] cos(<q, om_j> + ph_j)
  if (n_fs > 0) {
    uint32_t ah[kMT][kSteps][4], al[kMT][kSteps][4];
    load_a(ah, al, false);
    // products from the reduced phases, in revolutions
    auto start = [&](float (&acc)[kMT][4], const Buf& u, int nt) {
      const float p0 = u.ph[nt * 8 + 2 * t], p1 = u.ph[nt * 8 + 2 * t + 1];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        acc[mt][0] = p0;
        acc[mt][1] = p1;
        acc[mt][2] = p0;
        acc[mt][3] = p1;
      }
      products(acc, u, nt * 8, ah, al);
    };
    auto finish = [&](float (&acc)[kMT][4], const Buf& u, int nt) {
      const int col0 = nt * 8;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float f = acc[mt][e] - rintf(acc[mt][e]);  // exact: revolutions
          acc[mt][e] = __cosf(f * kTwoPiF);
        }
      }
      if (u.tw[nt] != 0.0f) {  // the same branches for every thread of the block
        // a wide column's 16 kMT values, one a lane, then to their owners
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + j;
          if (u.wide[col] == 0.0f) continue;
          const int row = row_base + lane % (16 * kMT);
          const float mine = cos_wide(qs + row * kStr, 1, u.raw + col * kD, d, u.phr[col]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = __shfl_sync(0xffffffffu, mine, mt * 16 + g + 8 * h);
              if (j == 2 * t) acc[mt][2 * h] = v;
              if (j == 2 * t + 1) acc[mt][2 * h + 1] = v;
            }
          }
        }
      }
      reduce_into(acc, u, col0);
    };
    for (int fs = 0; fs < n_fs; ++fs, ++s) {
      const Buf u = buffer(s);
      split_features(u);
      __syncthreads();  // this stage is split; every warp is done with stage s - 1
      if (fs + 1 < n_fs) {
        prefetch(true, (fs + 1) * kStage);
      } else if (n_ps > 0) {
        prefetch(false, 0);
      }
      // all 8 n-tiles, also past a ragged end (zero rows and weights there)
      pipeline(u, start, finish);
    }
  }

  // the cross term: sum_j amp V[j] k_nu(|q~ - x~_j|^2)
  if (n_ps > 0) {
    uint32_t ah[kMT][kSteps][4], al[kMT][kSteps][4];
    load_a(ah, al, true);
    float nq[kMT][2];  // |q~|^2 of the thread's rows, an FMA chain in dimension order
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_base + mt * 16 + g + 8 * h;
        float n = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float v = a_value(row, k, true);
          n = fmaf(v, v, n);
        }
        nq[mt][h] = n;
      }
    }
    // products from |q~|^2: d2 itself
    auto start = [&](float (&acc)[kMT][4], const Buf& u, int nt) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        acc[mt][0] = acc[mt][1] = nq[mt][0];
        acc[mt][2] = acc[mt][3] = nq[mt][1];
      }
      products(acc, u, nt * 8, ah, al);
    };
    auto finish = [&](float (&acc)[kMT][4], const Buf& u, int nt) {
      const int col0 = nt * 8;
      float near_below[kMT][2];  // d2 under this is a near pair's
      bool near = false;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) near_below[mt][h] = kNearShare * (nq[mt][h] + u.tw[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) near |= acc[mt][e] < near_below[mt][e >> 1];
      }
      if (__any_sync(0xffffffffu, near)) {  // rare at d = 15: d2 again from differences
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!(acc[mt][e] < near_below[mt][e >> 1])) continue;
            const int row = row_base + mt * 16 + g + 8 * (e >> 1);
            const float* xs = u.raw + (col0 + 2 * t + (e & 1)) * kD;
            float d2 = 0.0f;
            for (int k = 0; k < d; ++k) {
              const float diff = a_value(row, k, true) - xs[k];
              d2 = fmaf(diff, diff, d2);
            }
            acc[mt][e] = d2;
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][e] = matern<kNu>(acc[mt][e] < 0.0f ? 0.0f : acc[mt][e]);  // keeps NaN
        }
      }
      reduce_into(acc, u, col0);
    };
    for (int ps = 0; ps < n_ps; ++ps, ++s) {
      const Buf u = buffer(s);
      split_points(u);
      __syncthreads();
      if (ps + 1 < n_ps) prefetch(false, (ps + 1) * kStage);
      pipeline(u, start, finish);
    }
  }

  // the four threads of a row hold its sums over their columns
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + row_base + mt * 16 + g + 8 * h;
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        float v = part[mt][h][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((c & 3) == t && c < a.r && i < a.m) a.out[((long long)b * a.m + i) * a.r + c] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// PR 10's design, for d >= 32: one thread per query, FP32 pipes
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 128;  // queries a block
constexpr int kTile = 64;          // features or training points staged at once

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// <q, row> over the padded dimensions, in order: one FMA chain; q is the
// thread's column of shared memory (element k at q[k * kSimtThreads])
__device__ __forceinline__ float dot_q(const float* q, const float* row, int dp) {
  float t = 0.0f;
  for (int k = 0; k < dp; k += 4) {
    const float4 o = *reinterpret_cast<const float4*>(row + k);
    t = fmaf(q[k * kSimtThreads], o.x, t);
    t = fmaf(q[(k + 1) * kSimtThreads], o.y, t);
    t = fmaf(q[(k + 2) * kSimtThreads], o.z, t);
    t = fmaf(q[(k + 3) * kSimtThreads], o.w, t);
  }
  return t;
}

// sum_k (q_k - row_k)^2 in order, q and row already scaled by 1/ls: the
// distance from differences
__device__ __forceinline__ float dist2_q(const float* q, const float* row, int dp) {
  float t = 0.0f;
  for (int k = 0; k < dp; k += 4) {
    const float4 o = *reinterpret_cast<const float4*>(row + k);
    float e = q[k * kSimtThreads] - o.x;
    t = fmaf(e, e, t);
    e = q[(k + 1) * kSimtThreads] - o.y;
    t = fmaf(e, e, t);
    e = q[(k + 2) * kSimtThreads] - o.z;
    t = fmaf(e, e, t);
    e = q[(k + 3) * kSimtThreads] - o.w;
    t = fmaf(e, e, t);
  }
  return t;
}

// rows[jj * dp + k] = src[(j0 + jj) * d + k] * (scale ? scale[k] : 1) for
// the cnt rows of a tile, zeros in the padded dimensions
__device__ __forceinline__ void stage_rows(float* rows, const float* src, int j0, int cnt,
                                           int d, int dp, const float* scale) {
  for (int e = threadIdx.x; e < cnt * dp; e += kSimtThreads) {
    const int jj = e / dp, k = e - jj * dp;
    float val = 0.0f;
    if (k < d) {
      val = src[(long long)(j0 + jj) * d + k];
      if (scale != nullptr) val *= scale[k];
    }
    rows[e] = val;
  }
}

// wv[jj * kR + c] = src[(j0 + jj) * r + c], zeros in the columns c >= r
template <int kR>
__device__ __forceinline__ void stage_cols(float* wv, const float* src, int j0, int cnt, int r) {
  for (int e = threadIdx.x; e < cnt * kR; e += kSimtThreads) {
    const int jj = e / kR, c = e - jj * kR;
    wv[e] = c < r ? src[(long long)(j0 + jj) * r + c] : 0.0f;
  }
}

template <int kNu, int kR>
__global__ void __launch_bounds__(kSimtThreads, 4)
pathwise_values_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dp = pad4(a.d);
  float* rows = smem;                   // kTile x dp: frequencies, or X / ls
  float* wv = rows + kTile * dp;        // kTile x kR: W, or V
  float* aux = wv + kTile * kR;         // kTile phases
  float* wide = aux + kTile;            // kTile: 1 where the float64 argument is taken
  float* red = wide + kTile;            // kSimtThreads / 32: max |q| of each warp
  float* ils = red + kSimtThreads / 32; // dp: 1/ls, zeros past d
  float* qcol = ils + dp;               // dp x kSimtThreads queries

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kSimtThreads + tid;
  // a thread past m computes a copy of the last query and stores nothing,
  // so every thread reaches every barrier
  const float* xq = a.xq + b * a.xq_stride + (long long)min(i, a.m - 1) * a.d;
  for (int k = 0; k < dp; ++k) qcol[k * kSimtThreads + tid] = k < a.d ? xq[k] : 0.0f;

  // the block's largest |query coordinate|, for the wide-argument test
  float qmax = 0.0f;
  for (int k = 0; k < a.d; ++k) qmax = fmaxf(qmax, fabsf(xq[k]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, s));
  if ((tid & 31) == 0) red[tid >> 5] = qmax;
  __syncthreads();
  qmax = red[0];
#pragma unroll
  for (int w = 1; w < kSimtThreads / 32; ++w) qmax = fmaxf(qmax, red[w]);

  float acc_f[kR], acc_k[kR];
#pragma unroll
  for (int c = 0; c < kR; ++c) acc_f[c] = acc_k[c] = 0.0f;

  // the random features: sum_j W[j] cos(<q, om_j> + ph_j)
  const float* om = a.omega + (long long)b * a.n_feat * a.d;
  const float* ph = a.phase + (long long)b * a.n_feat;
  const float* w = a.w + (long long)b * a.n_feat * a.r;
  for (int j0 = 0; j0 < a.n_feat; j0 += kTile) {
    const int cnt = min(kTile, a.n_feat - j0);
    __syncthreads();  // every thread is done with the previous tile
    stage_rows(rows, om, j0, cnt, a.d, dp, nullptr);
    stage_cols<kR>(wv, w, j0, cnt, a.r);
    for (int e = tid; e < cnt; e += kSimtThreads) aux[e] = ph[j0 + e];
    __syncthreads();
    for (int e = tid; e < cnt; e += kSimtThreads) {
      float s = 0.0f;
      for (int k = 0; k < dp; ++k) s += fabsf(rows[e * dp + k]);
      wide[e] = fabsf(aux[e]) + qmax * s > kWideArg ? 1.0f : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < cnt; ++jj) {
      const float* row = rows + jj * dp;
      const float cs = wide[jj] != 0.0f  // the same branch for every thread of the block
                           ? cos_wide(qcol + tid, kSimtThreads, row, dp, aux[jj])
                           : cosf(dot_q(qcol + tid, row, dp) + aux[jj]);
#pragma unroll
      for (int c = 0; c < kR; ++c) acc_f[c] = fmaf(wv[jj * kR + c], cs, acc_f[c]);
    }
  }

  // the cross term: sum_j V[j] k_nu(|q / ls - x_j / ls|^2)
  if (a.x != nullptr) {
    for (int k = tid; k < dp; k += kSimtThreads) {
      ils[k] = k < a.d ? a.inv_ls[(long long)b * a.d + k] : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < dp; ++k) qcol[k * kSimtThreads + tid] *= ils[k];
    const float* xb = a.x + b * a.x_stride;
    const float* v = a.v + (long long)b * a.n_pts * a.r;
    for (int j0 = 0; j0 < a.n_pts; j0 += kTile) {
      const int cnt = min(kTile, a.n_pts - j0);
      __syncthreads();
      stage_rows(rows, xb, j0, cnt, a.d, dp, ils);
      stage_cols<kR>(wv, v, j0, cnt, a.r);
      __syncthreads();
#pragma unroll 2
      for (int jj = 0; jj < cnt; ++jj) {
        const float kv = matern<kNu>(dist2_q(qcol + tid, rows + jj * dp, dp));
#pragma unroll
        for (int c = 0; c < kR; ++c) acc_k[c] = fmaf(wv[jj * kR + c], kv, acc_k[c]);
      }
    }
  }

  if (i < a.m) {
    const float coef = a.coef[b];
    float* o = a.out + ((long long)b * a.m + i) * a.r;
    if (a.x != nullptr) {
      const float amp = a.amp[b];
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        if (c < a.r) o[c] = coef * acc_f[c] + amp * acc_k[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < kR; ++c) {
        if (c < a.r) o[c] = coef * acc_f[c];
      }
    }
  }
}

// dynamic shared memory of the FP32 kernel for (d, r)
size_t simt_smem_bytes(int d, int r) {
  const int kr = r == 1 ? 1 : kMaxR;
  const int dp = pad4(d);
  return sizeof(float) *
         (size_t)(kTile * dp + kTile * kr + 2 * kTile + kSimtThreads / 32 + dp + dp * kSimtThreads);
}

// ---------------------------------------------------------------------------
// the launch plan
// ---------------------------------------------------------------------------

using Kernel = void (*)(const Args);

template <int kNu>
Kernel mma_for(int d, int r) {
  if (d < 16) return r == 1 ? pathwise_mma_kernel<kNu, 16, 1> : pathwise_mma_kernel<kNu, 16, kMaxR>;
  return r == 1 ? pathwise_mma_kernel<kNu, 32, 1> : pathwise_mma_kernel<kNu, 32, kMaxR>;
}

template <int kNu>
Kernel simt_for(int r) {
  return r == 1 ? pathwise_values_kernel<kNu, 1> : pathwise_values_kernel<kNu, kMaxR>;
}

struct Plan {
  Kernel kernel;
  size_t smem;      // dynamic shared memory per block, bytes
  int threads;      // per block
  int queries;      // per block
  int tensor_cores; // 1: pathwise_mma_kernel, 0: pathwise_values_kernel
};

Plan plan_for(int nu_code, int d, int r) {
  Plan p;
  p.tensor_cores = d <= kMmaMaxD;
  if (p.tensor_cores) {
    const bool narrow = d < 16, r1 = r == 1;
    p.kernel = nu_code == 0   ? mma_for<0>(d, r)
               : nu_code == 1 ? mma_for<1>(d, r)
               : nu_code == 2 ? mma_for<2>(d, r)
                              : mma_for<3>(d, r);
    p.smem = narrow ? (r1 ? mma_smem_bytes<16, 1>() : mma_smem_bytes<16, kMaxR>())
                    : (r1 ? mma_smem_bytes<32, 1>() : mma_smem_bytes<32, kMaxR>());
    p.threads = kThreads;
    p.queries = narrow ? Shape<16>::kQueries : Shape<32>::kQueries;
  } else {
    p.kernel = nu_code == 0   ? simt_for<0>(r)
               : nu_code == 1 ? simt_for<1>(r)
               : nu_code == 2 ? simt_for<2>(r)
                              : simt_for<3>(r);
    p.smem = simt_smem_bytes(d, r);
    p.threads = kSimtThreads;
    p.queries = kSimtThreads;
  }
  return p;
}

bool valid(int d, int r, int nu_code) {
  return d >= 1 && d <= kMaxD && r >= 1 && r <= kMaxR && nu_code >= 0 && nu_code <= 3;
}

}  // namespace

// K5. xq_stride / x_stride are 0 (shared) or m * d / n_pts * d floats; x ==
// nullptr leaves the cross term out (inv_ls, v and amp are then not read).
// 1 <= r <= 8, 1 <= d <= 256, B <= 65535.
extern "C" int bask_pathwise_values_f32(
    const float* xq, long long xq_stride, const float* omega, const float* phase,
    const float* w, const float* coef, const float* x, long long x_stride,
    const float* inv_ls, const float* v, const float* amp, float* out, int B, int m,
    int n_feat, int n_pts, int d, int r, int nu_code, void* stream) {
  if (B < 0 || B > 65535 || m < 0 || n_feat < 0 || n_pts < 0 || !valid(d, r, nu_code)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || m == 0) return (int)cudaSuccess;
  const Args a{xq, xq_stride, omega, phase, w, coef, x, x_stride, inv_ls, v, amp, out,
               m, n_feat, n_pts, d, r};
  const Plan p = plan_for(nu_code, d, r);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + p.queries - 1) / p.queries, B);
  p.kernel<<<grid, p.threads, p.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K5's launch plan for (d, r, nu_code) on the current device, into
// info[0..3]: the kernel (1 tensor cores, 0 FP32), dynamic shared memory
// per block (bytes), queries per block, resident blocks per SM.
extern "C" int bask_pathwise_values_info(int d, int r, int nu_code, int* info) {
  if (!valid(d, r, nu_code)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(nu_code, d, r);
  cudaError_t err = cudaSuccess;
  if (p.smem > 48 * 1024) {  // as the launch sets it: never below the default 48 KB
    err = cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
  }
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.kernel, p.threads, p.smem);
  }
  if (err != cudaSuccess) return (int)err;
  info[0] = p.tensor_cores;
  info[1] = (int)p.smem;
  info[2] = p.queries;
  info[3] = blocks;
  return 0;
}
