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
// What bounds it on an H100: arithmetic. Per (query, feature) pair 2d + 4
// float32 operations (the dot, the phase, the cosine counted as one, the
// multiply-add), per (query, training point) pair 2d + 8 (the scaled
// difference and its square per dimension, the root, exp, the polynomial,
// the multiply-add); ops/pathwise_values.py::k5_operations. At the batch
// ask's shape (256 rows, 65,536 queries, 1,024 features, 1,000 real of
// 1,024 points, d = 15) that is 1.22e12 operations, 18.2 ms at
// 67 TFLOP/s, against ~0.1 GB of inputs and output. The design, simple
// and right first:
//
// * grid (query tiles of 128, rows); each thread owns one query, keeps its
//   coordinates in registers (d <= 32; padded with zeros to 16 or 32) or,
//   above that, in its own column of shared memory, and R <= 8 float32
//   sums for each of the two terms;
// * the block walks the features, then the training points, in tiles of
//   64 staged in shared memory (the frequencies, phases and W; then X
//   scaled by 1/ls and V), read by every thread as broadcasts;
// * the cosine is full-precision cosf (Matern-1/2 frequencies have a
//   Cauchy tail: arguments of 1e3-1e5 occur, where __cosf is wrong). A
//   float32 argument of 1e5 is itself off by up to ~1e-2 rad (its
//   spacing and the dot's rounding), so a feature whose argument may pass
//   kWideArg for some query of the block (|phase| + max|q| sum_k |om_k|,
//   known when the tile is staged) has its dot summed in float64 and
//   reduced by 2 pi in float64 before cosf: a branch that is the same for
//   every thread of the block, taken by a few features of a Matern-1/2
//   draw and almost never at nu >= 3/2;
// * the distance is formed from differences, never as norms minus a dot,
//   as in the plain version; k_nu is gram_common.cuh's matern<kNu>, the
//   grams' epilogue;
// * every sum runs in a fixed order and each thread writes its R values
//   once: no atomics, so the draws (and top-k indices taken from them)
//   are the same from run to run.
//
// Queries are addressed as xq + b * xq_stride (stride 0: one grid shared by
// every row), training points as x + b * x_stride; x == nullptr leaves the
// cross term out (f0 at the training points). FP32 FMAs only.

#include <cuda_runtime.h>

#include "gram_common.cuh"

namespace {

constexpr int kThreads = 128;  // queries a block
constexpr int kTile = 64;      // features or training points staged at once
constexpr int kMaxR = 8;       // columns a launch
constexpr int kMaxD = 256;     // input dimensions (the shared-memory query)
// a feature whose argument may exceed this takes the float64 argument: below
// it the float32 argument is within ~4 x 2^-24 x 256 ~ 6e-5 rad
constexpr float kWideArg = 256.0f;

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

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// <q, row> over the padded dimensions, in order: one FMA chain. The query
// q is the thread's registers (kD > 0, a multiple of 4) or its column of
// shared memory (kD == 0: element k at q[k * kThreads], dp of them).
template <int kD>
__device__ __forceinline__ float dot_q(const float (&q)[kD], const float* row) {
  float t = 0.0f;
#pragma unroll
  for (int k = 0; k < kD; k += 4) {
    const float4 o = *reinterpret_cast<const float4*>(row + k);
    t = fmaf(q[k], o.x, t);
    t = fmaf(q[k + 1], o.y, t);
    t = fmaf(q[k + 2], o.z, t);
    t = fmaf(q[k + 3], o.w, t);
  }
  return t;
}

__device__ __forceinline__ float dot_q(const float* q, const float* row, int dp) {
  float t = 0.0f;
  for (int k = 0; k < dp; k += 4) {
    const float4 o = *reinterpret_cast<const float4*>(row + k);
    t = fmaf(q[k * kThreads], o.x, t);
    t = fmaf(q[(k + 1) * kThreads], o.y, t);
    t = fmaf(q[(k + 2) * kThreads], o.z, t);
    t = fmaf(q[(k + 3) * kThreads], o.w, t);
  }
  return t;
}

// sum_k (q_k - row_k)^2 in order, q and row already scaled by 1/ls: the
// distance from differences, never as norms minus a dot
template <int kD>
__device__ __forceinline__ float dist2_q(const float (&q)[kD], const float* row) {
  float t = 0.0f;
#pragma unroll
  for (int k = 0; k < kD; k += 4) {
    const float4 o = *reinterpret_cast<const float4*>(row + k);
    float e = q[k] - o.x;
    t = fmaf(e, e, t);
    e = q[k + 1] - o.y;
    t = fmaf(e, e, t);
    e = q[k + 2] - o.z;
    t = fmaf(e, e, t);
    e = q[k + 3] - o.w;
    t = fmaf(e, e, t);
  }
  return t;
}

__device__ __forceinline__ float dist2_q(const float* q, const float* row, int dp) {
  float t = 0.0f;
  for (int k = 0; k < dp; k += 4) {
    const float4 o = *reinterpret_cast<const float4*>(row + k);
    float e = q[k * kThreads] - o.x;
    t = fmaf(e, e, t);
    e = q[(k + 1) * kThreads] - o.y;
    t = fmaf(e, e, t);
    e = q[(k + 2) * kThreads] - o.z;
    t = fmaf(e, e, t);
    e = q[(k + 3) * kThreads] - o.w;
    t = fmaf(e, e, t);
  }
  return t;
}

// cos(t) for a float64 argument: reduced by 2 pi in float64 (the products
// q_k om_k of two floats are exact in float64), then cosf of the remainder
__device__ __forceinline__ float cos_reduced(double t) {
  constexpr double kTwoPi = 6.283185307179586, kInvTwoPi = 0.15915494309189535;
  return cosf((float)fma(-kTwoPi, rint(t * kInvTwoPi), t));
}

template <int kD>
__device__ __forceinline__ float cos_wide(const float (&q)[kD], const float* row, float ph) {
  double t = ph;
#pragma unroll
  for (int k = 0; k < kD; ++k) t = fma((double)q[k], (double)row[k], t);
  return cos_reduced(t);
}

__device__ __forceinline__ float cos_wide(const float* q, const float* row, int dp, float ph) {
  double t = ph;
  for (int k = 0; k < dp; ++k) t = fma((double)q[k * kThreads], (double)row[k], t);
  return cos_reduced(t);
}

// rows[jj * dp + k] = src[(j0 + jj) * d + k] * (scale ? scale[k] : 1) for
// the cnt rows of a tile, zeros in the padded dimensions
__device__ __forceinline__ void stage_rows(float* rows, const float* src, int j0, int cnt,
                                           int d, int dp, const float* scale) {
  for (int e = threadIdx.x; e < cnt * dp; e += kThreads) {
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
  for (int e = threadIdx.x; e < cnt * kR; e += kThreads) {
    const int jj = e / kR, c = e - jj * kR;
    wv[e] = c < r ? src[(long long)(j0 + jj) * r + c] : 0.0f;
  }
}

template <int kNu, int kD, int kR>
__global__ void __launch_bounds__(kThreads, 4)
pathwise_values_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dp = kD > 0 ? kD : pad4(a.d);
  float* rows = smem;               // kTile x dp: frequencies, or X / ls
  float* wv = rows + kTile * dp;    // kTile x kR: W, or V
  float* aux = wv + kTile * kR;     // kTile phases
  float* wide = aux + kTile;        // kTile: 1 where the float64 argument is taken
  float* red = wide + kTile;        // kThreads / 32: max |q| of each warp
  float* ils = red + kThreads / 32; // dp: 1/ls, zeros past d
  float* qcol = ils + dp;           // kD == 0: dp x kThreads queries

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  // a thread past m computes a copy of the last query and stores nothing,
  // so every thread reaches every barrier
  const float* xq = a.xq + b * a.xq_stride + (long long)min(i, a.m - 1) * a.d;

  constexpr int kQ = kD > 0 ? kD : 4;  // registers unused when kD == 0
  float qreg[kQ];
  if constexpr (kD > 0) {
#pragma unroll
    for (int k = 0; k < kD; ++k) qreg[k] = k < a.d ? xq[k] : 0.0f;
  } else {
    for (int k = 0; k < dp; ++k) qcol[k * kThreads + tid] = k < a.d ? xq[k] : 0.0f;
  }

  // the block's largest |query coordinate|, for the wide-argument test
  float qmax = 0.0f;
  for (int k = 0; k < a.d; ++k) qmax = fmaxf(qmax, fabsf(xq[k]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, s));
  if ((tid & 31) == 0) red[tid >> 5] = qmax;
  __syncthreads();
  qmax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) qmax = fmaxf(qmax, red[w]);

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
    for (int e = tid; e < cnt; e += kThreads) aux[e] = ph[j0 + e];
    __syncthreads();
    for (int e = tid; e < cnt; e += kThreads) {
      float s = 0.0f;
      for (int k = 0; k < dp; ++k) s += fabsf(rows[e * dp + k]);
      wide[e] = fabsf(aux[e]) + qmax * s > kWideArg ? 1.0f : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < cnt; ++jj) {
      const float* row = rows + jj * dp;
      float cs;
      if (wide[jj] != 0.0f) {  // the same branch for every thread of the block
        if constexpr (kD > 0) {
          cs = cos_wide(qreg, row, aux[jj]);
        } else {
          cs = cos_wide(qcol + tid, row, dp, aux[jj]);
        }
      } else {
        float t;
        if constexpr (kD > 0) {
          t = dot_q(qreg, row);
        } else {
          t = dot_q(qcol + tid, row, dp);
        }
        cs = cosf(t + aux[jj]);
      }
#pragma unroll
      for (int c = 0; c < kR; ++c) acc_f[c] = fmaf(wv[jj * kR + c], cs, acc_f[c]);
    }
  }

  // the cross term: sum_j V[j] k_nu(|q / ls - x_j / ls|^2)
  if (a.x != nullptr) {
    for (int k = tid; k < dp; k += kThreads) {
      ils[k] = k < a.d ? a.inv_ls[(long long)b * a.d + k] : 0.0f;
    }
    __syncthreads();
    if constexpr (kD > 0) {
#pragma unroll
      for (int k = 0; k < kD; ++k) qreg[k] *= ils[k];
    } else {
      for (int k = 0; k < dp; ++k) qcol[k * kThreads + tid] *= ils[k];
    }
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
        float d2;
        if constexpr (kD > 0) {
          d2 = dist2_q(qreg, rows + jj * dp);
        } else {
          d2 = dist2_q(qcol + tid, rows + jj * dp, dp);
        }
        const float kv = matern<kNu>(d2);
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

template <int kNu, int kD>
auto kernel_for_r(int r) {
  return r == 1 ? pathwise_values_kernel<kNu, kD, 1> : pathwise_values_kernel<kNu, kD, kMaxR>;
}

template <int kNu>
auto kernel_for_d(int d, int r) {
  return d <= 16 ? kernel_for_r<kNu, 16>(r)
         : d <= 32 ? kernel_for_r<kNu, 32>(r)
                   : kernel_for_r<kNu, 0>(r);
}

auto kernel_for(int nu_code, int d, int r) {
  return nu_code == 0   ? kernel_for_d<0>(d, r)
         : nu_code == 1 ? kernel_for_d<1>(d, r)
         : nu_code == 2 ? kernel_for_d<2>(d, r)
                        : kernel_for_d<3>(d, r);
}

// dynamic shared memory of the instantiation for (d, r)
size_t smem_bytes(int d, int r) {
  const int kr = r == 1 ? 1 : kMaxR;
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : pad4(d);
  const int qcol = d <= 32 ? 0 : dp * kThreads;
  return sizeof(float) * (size_t)(kTile * dp + kTile * kr + 2 * kTile + kThreads / 32 + dp + qcol);
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
  if (B < 0 || B > 65535 || m < 0 || n_feat < 0 || n_pts < 0 || d < 1 || d > kMaxD ||
      r < 1 || r > kMaxR || nu_code < 0 || nu_code > 3) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || m == 0) return (int)cudaSuccess;
  const Args a{xq, xq_stride, omega, phase, w, coef, x, x_stride, inv_ls, v, amp, out,
               m, n_feat, n_pts, d, r};
  const auto kernel = kernel_for(nu_code, d, r);
  const size_t smem = smem_bytes(d, r);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + kThreads - 1) / kThreads, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
