// K1, K2 and K4: fused masked Matern/RBF gram for a batch of walkers, float32.
//
// K1 replaces bask_tpu/ops/pallas_gram.py::fused_masked_gram_batch (math in
// _tile_values, packing in _pack_params), K2 replaces
// ::fused_masked_gram_lower_batch. Both are the one templated kernel
// below; kLower selects K2.
//
// What bounds it on an H100: the output write. At the chain's shape
// (50, 512, 512) that is 52.4 MB, 15.7 us at 3.35 TB/s, against ~2d + 20
// instructions per entry (the d-long dot, a sqrt and an exp). The design:
//
// * Packing inside. Each block reads its walker's row of thetas and forms
//   amp = exp(theta_0), noise = exp(theta_white) and 1/ls_k = exp(-theta_ls)
//   itself with expf, from the spec's flags (has_const, has_white, n_ls of
//   1 or d), so the wrapper issues no device operation besides the launch.
// * One block computes a 64 x 128 tile of one walker's gram with 256
//   threads. Thread (lane, warp) owns rows warp + 8i (i < 8) and the 4
//   columns 4 lane .. 4 lane + 3: a register tile of 32 dot products, fed
//   per input dimension by one 16-byte shared-memory read of the columns
//   and two broadcast 16-byte reads of the rows.
// * The tile's 64 + 128 rows of X are staged with coalesced loads (the
//   rows of a tile are contiguous in X, so consecutive threads read
//   consecutive floats and none idles on d = 15), scaled by 1/ls on the
//   way into shared memory, in chunks of 16 input dimensions.
// * Each row's and each column's squared norm is computed once per tile,
//   into shared memory, by the FMA chain of the dot product: norm and dot
//   of a point with itself are then the same chain over the same floats
//   in the same order, so d2(i, i) = |xi|^2 + |xi|^2 - 2 xi.xi is exactly 0.
// * Each thread stores its 4 columns as one float4, so a warp writes 512
//   contiguous bytes of one row.
// * nu is a template argument, the root is one sqrt.approx, and a tile
//   off the diagonal and inside the real block skips the masks: the
//   epilogue of the 32 entries is straight-line code the compiler can
//   interleave (a run-time nu and IEEE sqrtf's slow-path call split it
//   into branches and took the kernel from 42 to 75 us on the H100).
//
// Measured on an H100 (PERF.md, scripts/kernel_variants.py): without
// its store the kernel is only ~1.3 us faster, without exp and sqrt
// ~7 us. The block's own latency (the X loads, the block's start) is
// ~4-9 % of its time at (256, 1024, 1024), where K4 below pays it once per
// wb walkers; the rest is the per-entry work at 80 registers.
//
// X is addressed as X + b * x_walker_stride: stride 0 means shared X.
// FP32 FMAs only (no tensor cores, no TF32).
//
// K2 (kLower) keeps K1's values on and below the diagonal and writes
// exact zeros in every strictly upper 128 x 128 tile (col0 / 128 >
// row0 / 128). Such a block stages nothing and computes nothing; it only
// stores its zeros, as float4s, so the output write (what bounds both
// kernels) is the same as K1's. The blocks that compute run K1's exact
// instruction sequence, so their entries are bit-identical to K1's.
//
// K4 (gram_wb_kernel) replaces benchmarks/bench_gram_wb.py::gram_wb: K1's
// gram for shared X, with one block serving wb walkers of one 64 x 128
// tile, so the per-block latency K1 pays per walker (the raw X loads, the
// block's start) is paid once per wb walkers. It is bound by the same
// output write. Raw X rows of the tile are staged into shared memory once
// (for d <= 16; a wider d re-stages each 16-wide chunk per walker, as K1
// does), then each walker scales them by its own 1/ls into the buffers K1
// computes from, so its values, norms, dots and epilogue are K1's own
// floats and FMA chains in K1's order: bit-equal to K1. The next walker's
// log params are copied into shared memory by cp.async while the current
// walker stores, so no register holds them (K1's tile already takes the
// 80 registers that three blocks per SM allow).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;    // tile rows
constexpr int kCols = 128;   // tile columns: 32 lanes x 4
constexpr int kWarps = 8;    // 256 threads
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerThread = kRows / kWarps;  // 8
constexpr int kChunk = 16;   // input dimensions staged at once
// row strides of the staged chunks: multiples of 4 for 16-byte reads,
// offset from 32 banks so that the staging stores spread over banks
constexpr int kIStride = kRows + 4;
constexpr int kJStride = kCols + 4;
constexpr int kStageI = kRows * kChunk / kThreads;  // staged floats a thread
constexpr int kStageJ = kCols * kChunk / kThreads;  // loads per chunk

// rows of the tile are staged so that thread warp's 8 rows (warp + 8i)
// sit next to each other: row r at slot (r % 8) * 8 + r / 8
__device__ __forceinline__ int row_slot(int r) {
  return (r % kWarps) * kRowsPerThread + r / kWarps;
}

// sqrt.approx.f32: one MUFU operation, within 2^-23 relative of the root
// (IEEE sqrtf adds a refinement and a slow-path call that splits every
// entry's code into branches); d2 + 1e-36 is a normal float
__device__ __forceinline__ float sqrt_mufu(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// one float from global to shared memory without a register (cp.async),
// and the wait for this thread's copies
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int kNu>  // 0: nu = 1/2, 1: 3/2, 2: 5/2, 3: RBF
__device__ __forceinline__ float matern(float d2) {
  if (kNu == 3) return expf(-0.5f * d2);
  const float r = sqrt_mufu(d2 + 1e-36f);
  if (kNu == 0) return expf(-r);
  if (kNu == 1) {
    const float s = 1.7320508075688772f * r;
    return (1.0f + s) * expf(-s);
  }
  const float s = 2.23606797749979f * r;
  return (1.0f + s + s * s * (1.0f / 3.0f)) * expf(-s);
}

struct Spec {
  int has_const;  // thetas[0] is log amp
  int has_white;  // thetas[off + n_ls] is log noise
  int n_ls;       // 1 (isotropic) or d lengthscales at thetas[off ..]
};

template <bool kLower, int kNu>
__global__ void __launch_bounds__(kThreads, 3)
gram_kernel(const float* __restrict__ thetas, long long theta_stride,
            Spec spec, const float* __restrict__ X,
            long long x_walker_stride, const float* __restrict__ alpha,
            int n_real, int n_pad, int d, float* __restrict__ out) {
  __shared__ __align__(16) float xi[kChunk][kIStride];
  __shared__ __align__(16) float xj[kChunk][kJStride];
  __shared__ __align__(16) float ni_s[kRows];  // by row slot
  __shared__ __align__(16) float nj_s[kCols];
  __shared__ float ils[kChunk];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = col0 + 4 * lane;  // first of this thread's 4 columns
  const bool col_in = col < n_pad;  // n_pad % 64 == 0: all 4 or none

  float* ob = out + (long long)b * n_pad * n_pad;
  if (kLower && (col0 >> 7) > (row0 >> 7)) {  // a strictly upper 128-tile
    if (col_in) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = row0 + warp + kWarps * i;
        *reinterpret_cast<float4*>(ob + (long long)row * n_pad + col) = z;
      }
    }
    return;  // the whole block leaves: no barrier is skipped
  }

  const float* th = thetas + (long long)b * theta_stride;
  const int off = spec.has_const ? 1 : 0;
  const float amp = spec.has_const ? expf(th[0]) : 1.0f;
  const float noise = spec.has_white ? expf(th[off + spec.n_ls]) : 0.0f;
  const float* xb = X + (long long)b * x_walker_stride;

  float dot[kRowsPerThread][4];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dot[i][q] = 0.0f;
  }
  float nrm = 0.0f;  // threads < 64: row tid's norm; < 192: column tid - 64

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    // element e of a chunk is row e / kc, dimension e % kc; the quotient
    // by a float reciprocal is exact here (e < 2^11, kc <= 16). The loads
    // of X are issued before 1/ls is formed, so their latency overlaps
    // the load of thetas.
    const float inv_kc = 1.0f / kc;
    float si[kStageI], sj[kStageJ];  // raw X, scaled once 1/ls is known
#pragma unroll
    for (int u = 0; u < kStageI; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      si[u] = e < kRows * kc ? xb[(long long)(row0 + r) * d + k0 + e - r * kc] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageJ; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      sj[u] = e < kCols * kc && col0 + r < n_pad
                  ? xb[(long long)(col0 + r) * d + k0 + e - r * kc]
                  : 0.0f;
    }
    if (tid < kc) {
      ils[tid] = expf(-th[off + (spec.n_ls == 1 ? 0 : k0 + tid)]);
    }
    __syncthreads();  // ils ready; the previous chunk's reads are done
#pragma unroll
    for (int u = 0; u < kStageI; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      const int kk = e - r * kc;
      if (e < kRows * kc) xi[kk][row_slot(r)] = si[u] * ils[kk];
    }
#pragma unroll
    for (int u = 0; u < kStageJ; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      const int kk = e - r * kc;
      if (e < kCols * kc) xj[kk][r] = sj[u] * ils[kk];
    }
    __syncthreads();
    if (tid < kRows) {
      for (int kk = 0; kk < kc; ++kk) {
        const float v = xi[kk][row_slot(tid)];
        nrm = fmaf(v, v, nrm);
      }
    } else if (tid < kRows + kCols) {
      for (int kk = 0; kk < kc; ++kk) {
        const float v = xj[kk][tid - kRows];
        nrm = fmaf(v, v, nrm);
      }
    }
    for (int kk = 0; kk < kc; ++kk) {
      const float4 vj = *reinterpret_cast<const float4*>(&xj[kk][4 * lane]);
      const float4 va =
          *reinterpret_cast<const float4*>(&xi[kk][kRowsPerThread * warp]);
      const float4 vb =
          *reinterpret_cast<const float4*>(&xi[kk][kRowsPerThread * warp + 4]);
      const float vi[kRowsPerThread] = {va.x, va.y, va.z, va.w,
                                        vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        dot[i][0] = fmaf(vi[i], vj.x, dot[i][0]);
        dot[i][1] = fmaf(vi[i], vj.y, dot[i][1]);
        dot[i][2] = fmaf(vi[i], vj.z, dot[i][2]);
        dot[i][3] = fmaf(vi[i], vj.w, dot[i][3]);
      }
    }
  }
  if (tid < kRows) {
    ni_s[row_slot(tid)] = nrm;
  } else if (tid < kRows + kCols) {
    nj_s[tid - kRows] = nrm;
  }
  __syncthreads();

  if (!col_in) return;  // after the last barrier
  const float4 nj4 = *reinterpret_cast<const float4*>(&nj_s[4 * lane]);
  const float nj[4] = {nj4.x, nj4.y, nj4.z, nj4.w};
  // a tile off the diagonal and inside the real block needs no mask
  const bool plain_tile = row0 + kRows <= n_real && col0 + kCols <= n_real &&
                          (row0 + kRows <= col0 || col0 + kCols <= row0);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + warp + kWarps * i;
    const float ni = ni_s[kRowsPerThread * warp + i];
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float d2 = ni + nj[q] - 2.0f * dot[i][q];
      d2 = d2 < 0.0f ? 0.0f : d2;  // keeps NaN, like jnp.maximum
      v[q] = amp * matern<kNu>(d2);
    }
    if (!plain_tile) {
      const bool row_real = row < n_real;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = col + q;
        const bool real = row_real && c < n_real;
        v[q] = real ? v[q] : 0.0f;
        if (row == c) v[q] = real ? v[q] + noise + alpha[row] : 1.0f;
      }
    }
    *reinterpret_cast<float4*>(ob + (long long)row * n_pad + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kLower>
auto gram_kernel_for(int nu_code) {
  return nu_code == 0   ? gram_kernel<kLower, 0>
         : nu_code == 1 ? gram_kernel<kLower, 1>
         : nu_code == 2 ? gram_kernel<kLower, 2>
                        : gram_kernel<kLower, 3>;
}

template <bool kLower>
int launch_gram(const float* thetas, long long theta_stride, int has_const,
                int has_white, int n_ls, const float* X,
                long long x_walker_stride, const float* alpha, int n_real,
                int B, int n_pad, int d, int nu_code, float* out,
                void* stream) {
  const int multiple = kLower ? 2 * kRows : kRows;
  if (B <= 0 || B > 65535 || n_pad <= 0 || n_pad % multiple || d <= 0 ||
      nu_code < 0 || nu_code > 3 || !(n_ls == 1 || n_ls == d)) {
    return (int)cudaErrorInvalidValue;
  }
  const Spec spec{has_const, has_white, n_ls};
  const dim3 grid((n_pad + kCols - 1) / kCols, n_pad / kRows, B);
  const auto kernel = gram_kernel_for<kLower>(nu_code);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      thetas, theta_stride, spec, X, x_walker_stride, alpha, n_real, n_pad,
      d, out);
  return (int)cudaGetLastError();
}

// K4: blockIdx.z = walker group g, walkers g * wb .. min(B, g * wb + wb) - 1;
// kOnce (d <= 16): the raw X of the tile is staged once for all walkers
template <int kNu, bool kOnce>
__global__ void __launch_bounds__(kThreads, 3)
gram_wb_kernel(const float* __restrict__ thetas, long long theta_stride,
               Spec spec, const float* __restrict__ X,
               const float* __restrict__ alpha, int n_real, int n_pad, int d,
               int B, int wb, float* __restrict__ out) {
  __shared__ __align__(16) float xr_i[kChunk][kIStride];  // raw X, K1's layout
  __shared__ __align__(16) float xr_j[kChunk][kJStride];
  __shared__ __align__(16) float xi[kChunk][kIStride];  // scaled by 1/ls
  __shared__ __align__(16) float xj[kChunk][kJStride];
  __shared__ __align__(16) float ni_s[kRows];  // by row slot
  __shared__ __align__(16) float nj_s[kCols];
  __shared__ float ils[kChunk];
  // a walker's log params, double-buffered by walker parity: chunk 0's
  // log ls at slot k (k < 16), log amp at 16, log noise at 17
  __shared__ float th_s[2][kChunk + 2];

  const int b0 = blockIdx.z * wb;
  const int nw = min(wb, B - b0);  // the guarded tail of B % wb
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = col0 + 4 * lane;
  const bool col_in = col < n_pad;
  const int off = spec.has_const ? 1 : 0;
  const bool plain_tile = row0 + kRows <= n_real && col0 + kCols <= n_real &&
                          (row0 + kRows <= col0 || col0 + kCols <= row0);

  // raw X of chunk k0 into xr_i / xr_j, by K1's element map; made visible
  // by the barrier after the walker's 1/ls is written
  auto stage = [&](int k0, int kc) {
    const float inv_kc = 1.0f / kc;
#pragma unroll
    for (int u = 0; u < kStageI; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      if (e < kRows * kc) {
        xr_i[e - r * kc][row_slot(r)] = X[(long long)(row0 + r) * d + k0 + e - r * kc];
      }
    }
#pragma unroll
    for (int u = 0; u < kStageJ; ++u) {
      const int e = tid + u * kThreads;
      const int r = (int)((e + 0.5f) * inv_kc);
      if (e < kCols * kc) {
        xr_j[e - r * kc][r] = col0 + r < n_pad
                                  ? X[(long long)(col0 + r) * d + k0 + e - r * kc]
                                  : 0.0f;
      }
    }
  };

  // walker b's log params into th_s[b & 1] by asynchronous copies (no
  // registers held while they fly); each thread copies what it reads
  // first itself, so its own wait makes chunk 0's log ls ready, and the
  // walker's first barrier publishes amp and noise
  auto fetch = [&](int b) {
    const float* th = thetas + (long long)b * theta_stride;
    float* slot = th_s[b & 1];
    if (tid < min(kChunk, d)) {
      copy_async4(slot + tid, th + off + (spec.n_ls == 1 ? 0 : tid));
    } else if (tid == kChunk && spec.has_const) {
      copy_async4(slot + kChunk, th);
    } else if (tid == kChunk + 1 && spec.has_white) {
      copy_async4(slot + kChunk + 1, th + off + spec.n_ls);
    }
  };

  fetch(b0);
  if (kOnce) stage(0, d);

  for (int w = 0; w < nw; ++w) {
    const int b = b0 + w;
    const float* ths = th_s[b & 1];
    copy_async_wait();

    float dot[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) dot[i][q] = 0.0f;
    }
    float nrm = 0.0f;

    for (int k0 = 0; k0 < (kOnce ? 1 : d); k0 += kChunk) {
      const int kc = kOnce ? d : min(kChunk, d - k0);
      // the previous chunk's (or walker's) reads of xr, ils and the
      // scaled buffers ended at its barriers
      if (!kOnce) stage(k0, kc);
      if (tid < kc) {
        ils[tid] = expf(-(k0 == 0 ? ths[tid]
                                  : thetas[(long long)b * theta_stride + off +
                                           (spec.n_ls == 1 ? 0 : k0 + tid)]));
      }
      __syncthreads();
      // scale: the same products K1 forms on the way into shared memory
      for (int e = tid; e < kc * kRows; e += kThreads) {
        const int kk = e / kRows;
        const int s = e - kk * kRows;
        xi[kk][s] = xr_i[kk][s] * ils[kk];
      }
      for (int e = tid; e < kc * kCols; e += kThreads) {
        const int kk = e / kCols;
        const int c = e - kk * kCols;
        xj[kk][c] = xr_j[kk][c] * ils[kk];
      }
      __syncthreads();
      if (tid < kRows) {
        for (int kk = 0; kk < kc; ++kk) {
          const float v = xi[kk][row_slot(tid)];
          nrm = fmaf(v, v, nrm);
        }
      } else if (tid < kRows + kCols) {
        for (int kk = 0; kk < kc; ++kk) {
          const float v = xj[kk][tid - kRows];
          nrm = fmaf(v, v, nrm);
        }
      }
      for (int kk = 0; kk < kc; ++kk) {
        const float4 vj = *reinterpret_cast<const float4*>(&xj[kk][4 * lane]);
        const float4 va =
            *reinterpret_cast<const float4*>(&xi[kk][kRowsPerThread * warp]);
        const float4 vb =
            *reinterpret_cast<const float4*>(&xi[kk][kRowsPerThread * warp + 4]);
        const float vi[kRowsPerThread] = {va.x, va.y, va.z, va.w,
                                          vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          dot[i][0] = fmaf(vi[i], vj.x, dot[i][0]);
          dot[i][1] = fmaf(vi[i], vj.y, dot[i][1]);
          dot[i][2] = fmaf(vi[i], vj.z, dot[i][2]);
          dot[i][3] = fmaf(vi[i], vj.w, dot[i][3]);
        }
      }
    }
    if (tid < kRows) {
      ni_s[row_slot(tid)] = nrm;
    } else if (tid < kRows + kCols) {
      nj_s[tid - kRows] = nrm;
    }
    // the next walker's log params fly during this walker's stores; its
    // buffer was last read in the previous walker's epilogue, which every
    // thread finished before this walker's first barrier
    if (w + 1 < nw) fetch(b + 1);
    __syncthreads();

    if (col_in) {  // K1's epilogue
      const float amp = spec.has_const ? expf(ths[kChunk]) : 1.0f;
      const float noise = spec.has_white ? expf(ths[kChunk + 1]) : 0.0f;
      float* ob = out + (long long)b * n_pad * n_pad;
      const float4 nj4 = *reinterpret_cast<const float4*>(&nj_s[4 * lane]);
      const float nj[4] = {nj4.x, nj4.y, nj4.z, nj4.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = row0 + warp + kWarps * i;
        const float ni = ni_s[kRowsPerThread * warp + i];
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float d2 = ni + nj[q] - 2.0f * dot[i][q];
          d2 = d2 < 0.0f ? 0.0f : d2;  // keeps NaN, like jnp.maximum
          v[q] = amp * matern<kNu>(d2);
        }
        if (!plain_tile) {
          const bool row_real = row < n_real;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = col + q;
            const bool real = row_real && c < n_real;
            v[q] = real ? v[q] : 0.0f;
            if (row == c) v[q] = real ? v[q] + noise + alpha[row] : 1.0f;
          }
        }
        *reinterpret_cast<float4*>(ob + (long long)row * n_pad + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

auto wb_kernel_for(int nu_code, int d) {
  const bool once = d <= kChunk;
  return nu_code == 0   ? (once ? gram_wb_kernel<0, true> : gram_wb_kernel<0, false>)
         : nu_code == 1 ? (once ? gram_wb_kernel<1, true> : gram_wb_kernel<1, false>)
         : nu_code == 2 ? (once ? gram_wb_kernel<2, true> : gram_wb_kernel<2, false>)
                        : (once ? gram_wb_kernel<3, true> : gram_wb_kernel<3, false>);
}

}  // namespace

// K1: n_pad must be a multiple of 64; thetas rows theta_stride floats apart.
extern "C" int bask_gram_f32(const float* thetas, long long theta_stride,
                             int has_const, int has_white, int n_ls,
                             const float* X, long long x_walker_stride,
                             const float* alpha, int n_real, int B, int n_pad,
                             int d, int nu_code, float* out, void* stream) {
  return launch_gram<false>(thetas, theta_stride, has_const, has_white, n_ls,
                            X, x_walker_stride, alpha, n_real, B, n_pad, d,
                            nu_code, out, stream);
}

// K2: the same arguments; n_pad must be a multiple of 128.
extern "C" int bask_gram_lower_f32(const float* thetas, long long theta_stride,
                                   int has_const, int has_white, int n_ls,
                                   const float* X, long long x_walker_stride,
                                   const float* alpha, int n_real, int B,
                                   int n_pad, int d, int nu_code, float* out,
                                   void* stream) {
  return launch_gram<true>(thetas, theta_stride, has_const, has_white, n_ls,
                           X, x_walker_stride, alpha, n_real, B, n_pad, d,
                           nu_code, out, stream);
}

// K4: K1's arguments plus wb; shared X only (x_walker_stride must be 0).
extern "C" int bask_gram_wb_f32(const float* thetas, long long theta_stride,
                                int has_const, int has_white, int n_ls,
                                const float* X, long long x_walker_stride,
                                const float* alpha, int n_real, int B,
                                int n_pad, int d, int nu_code, int wb,
                                float* out, void* stream) {
  if (x_walker_stride != 0 || wb < 1 || B <= 0 || n_pad <= 0 ||
      n_pad % kRows || d <= 0 || nu_code < 0 || nu_code > 3 ||
      !(n_ls == 1 || n_ls == d) || (B + wb - 1) / wb > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Spec spec{has_const, has_white, n_ls};
  const dim3 grid((n_pad + kCols - 1) / kCols, n_pad / kRows, (B + wb - 1) / wb);
  wb_kernel_for(nu_code, d)<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      thetas, theta_stride, spec, X, alpha, n_real, n_pad, d, B, wb, out);
  return (int)cudaGetLastError();
}

// Resident blocks per SM on the current device of K1 (kernel 0), K2 (1)
// or K4 (2) for nu_code and d, from the occupancy calculator: what the
// built kernel's registers and shared memory allow. K4's wb is a run-time
// argument, so the count holds for every wb.
extern "C" int bask_gram_blocks_per_sm(int kernel, int nu_code, int d,
                                       int* blocks) {
  if (kernel < 0 || kernel > 2 || nu_code < 0 || nu_code > 3 || d <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(kernel == 0   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                   blocks, gram_kernel_for<false>(nu_code), kThreads, 0)
               : kernel == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                   blocks, gram_kernel_for<true>(nu_code), kThreads, 0)
                             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                   blocks, wb_kernel_for(nu_code, d), kThreads, 0));
}

extern "C" const char* bask_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
