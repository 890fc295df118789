// K4: the walker-batched gram for shared X, float32, designed for Hopper.
//
// Replaces benchmarks/bench_gram_wb.py::gram_wb (the pallas_call at :109):
// K1's function (gram.cu; ops/gram.py::fused_masked_gram_plain) for
// (n_pad, d) inputs shared by all B walkers, with wb walkers served by
// one work unit. For walker b:
//
//   d2 = |x_i/ls|^2 + |x_j/ls|^2 - 2 (x_i/ls).(x_j/ls),  K = amp k_nu(d2)
//
// masked outside the n_real x n_real block, + noise + alpha_i on the real
// diagonal, 1 on the padded diagonal.
//
// What bounds it on an H100: the output write, 4 B n_pad^2 bytes (321 us
// at (256, 1024, 1024), 15.7 us at (50, 512, 512) at 3.35 TB/s). K1 does
// the d-long dot on the FP32 pipe (~2d instructions an entry besides the
// ~13 of the epilogue) and stores from the registers of the warps that
// compute. The design:
//
// * Half the work: the gram is symmetric, so a unit computes one tile on
//   or below the diagonal and stores it twice, as tile (ti, tj) and,
//   transposed, as tile (tj, ti); a diagonal tile computes its lower
//   triangle and mirrors it. Every K[b] is then exactly symmetric.
// * A persistent grid. A unit is (a group of wb walkers, one 128 x 128
//   tile on or below the diagonal); min(units, blocks per SM x SMs)
//   blocks of 544 threads walk the units by a static stride, the walkers
//   of a unit in order. No work counter: the launch is the only device
//   operation of a call.
// * X resident in shared memory. Where (n_pad, d) fits beside the buffers
//   below (n_pad d <= ~18,500 floats, e.g. (1024, 15)), each block copies
//   the whole X into dynamic shared memory with one bulk copy
//   (cp.async.bulk, completed on an mbarrier) at its start. Otherwise it
//   reads each unit's rows and columns from global memory (L2), one step
//   ahead: a step's raw X is loaded into registers while the step before
//   runs its products and epilogue, so the loads overlap the work. A
//   walker's thetas are loaded a step ahead too.
// * Centred points. d2 does not change when every point moves by the same
//   c, and the rounding of the norms and the cross term scales with
//   |x/ls|^2: each block takes c = the mean of X's first 64 rows (a fixed
//   reduction, the same floats in every block), which makes |x/ls|^2 ~4x
//   smaller for points spread evenly over a box.
// * Per (walker, unit) step, each warp scales 16 of the unit's 128 rows
//   and 128 columns, (x - c) / ls, into shared memory, 16 input
//   dimensions at a time, zero-padded to a multiple of 8, and forms each
//   point's |(x - c)/ls|^2 by an FP32 FMA chain over its dimensions in
//   order (the same chain for a point wherever it sits: norms do not
//   depend on the tile, the walker's batch or wb).
// * The cross term on the tensor cores in 3xTF32: each operand x is split
//   into hi = tf32(x) (to nearest) and lo = x - hi, and
//   dot = lo.hi + hi.lo + hi.hi accumulates in f32 through
//   mma.sync.m16n8k8.tf32 (small terms first). Each of 16 warps owns a
//   32 x 32 sub-tile (2 x 4 MMA tiles, 32 accumulators a thread). This is
//   the counterpart of the JAX kernel's Precision.HIGHEST product; its
//   error is ~2^-22 relative per product against ~2^-24 for K1's FMAs,
//   inside the 4e-6 max|K| the gram is held to (tests/test_torch_gram_wb.py
//   emulates the arithmetic). The kOnePass flag builds the same kernel
//   with hi.hi only (plain TF32), a control that misses that bound.
// * d2 = n_i + n_j - 2 dot, clamped at 0 with NaN kept, and set to exactly
//   0 where the global row equals the global column (the norms and the
//   dot come from different arithmetic, so the identity that makes K1's
//   d2(i, i) zero does not hold here); then K1's Matern, mask and diagonal
//   math (gram_common.cuh), so a diagonal entry is amp + noise + alpha_i
//   as K1 forms it, and 1 where padded.
// * Asynchronous stores. The epilogue writes the tile into a staging tile
//   in shared memory and its transpose into a second one, each as four
//   TMA boxes of 32 columns x 128 rows in the 128-byte swizzle (the float2
//   writes of the accumulator layout and the transposed scalar writes then
//   touch each bank the least number of times). After fence.proxy.async
//   the 16 computing warps arrive on an mbarrier; a 17th warp, outside
//   their barriers, stores the boxes with cp.async.bulk.tensor (a tensor
//   map encoded on the host per call; it clips what passes n_pad), waits
//   until the TMA has read them and frees the tiles on a second mbarrier.
//   The stores drain while the computing warps scale and multiply the next
//   step; they wait for the free tiles only before its epilogue. (Storing
//   each row with its own cp.async.bulk from the computing warps cost
//   ~1.5-3 us a step on the H100, in the warps that issued them.)
//
// Every entry's arithmetic is fixed by its (row, column) and its walker's
// thetas: a walker's values do not depend on B, wb or the block that
// computes them. Not bit-equal to K1, whose dot is an FMA chain.
//
// Shared memory per block: two staging tiles (131,072 B), the operands
// (20,480 B), two norm rows, two parameter rows, the centre, three
// mbarriers, 1,024 B of alignment and the resident X: 216,336 B at
// (1024, 15), so one block (16 computing warps and the storing warp) per SM.

#include <cuda.h>  // CUtensorMap; the driver is reached through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gram_common.cuh"

namespace {

constexpr int kTile = 128;                 // a unit's output tile, kTile x kTile
constexpr int kWarps = 16;                 // 4 x 4 warps, a 32 x 32 sub-tile each
constexpr int kThreads = kWarps * 32;      // the computing threads
constexpr int kBlockThreads = kThreads + 32;  // and one warp that stores
constexpr int kPoints = 2 * kTile;         // a unit's rows, then its columns
constexpr int kPtsPerWarp = kPoints / kWarps;  // 16
constexpr int kKc = 16;                    // input dimensions per chunk (2 k-steps)
constexpr int kRawPerLane = kPtsPerWarp * kKc / 32;  // 8
// operand rows of 20 floats: the lanes (g, t) of a fragment load read
// banks 20 g + t, all distinct
constexpr int kOpStride = kKc + 4;
constexpr int kBox = 32;                   // a TMA box: kBox columns x kTile rows
constexpr int kTileFloats = kTile * kTile;
constexpr int kCentreRows = 64;            // X's rows whose mean is the centre
// two staging tiles, the operands, two norm rows, 3 mbarriers, and 1024 bytes
// to align the tiles for the TMA's 128-byte swizzle
constexpr long long kFixedBytes =
    4LL * (2 * kTileFloats + kPoints * kOpStride + 2 * kPoints) + 32 + 1024;

__host__ __device__ __forceinline__ int params_stride(int d) {
  return (d + 2 + 3) & ~3;  // 1/ls_0 .. 1/ls_{d-1}, amp, noise; 16-byte rows
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// element (r, c) of a staging tile: four TMA boxes of 32 columns, each
// kTile rows of 128 bytes whose 16-byte chunks are swizzled by the row
// (chunk ^ r % 8, the TMA's 128-byte swizzle). The float2 writes of the
// accumulator layout and the transposed scalar writes then touch every
// bank the least number of times.
__device__ __forceinline__ int staged(int r, int c) {
  return (c >> 5) * (kTile * kBox) + r * kBox + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// X (bytes, 16-byte aligned, a multiple of 16) into shared memory by the
// TMA, completing on the mbarrier at bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box (kBox columns x kTile rows of walker b, from column c and row
// r) from shared memory to the gram by the TMA; the map clips what passes
// n_pad
__device__ __forceinline__ void tensor_store(const CUtensorMap* map, uint32_t src, int c, int r,
                                             int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(r), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int kNu, bool kResident, bool kOnePass>
__global__ void __launch_bounds__(kBlockThreads, 1)
gram_wb_kernel(const float* __restrict__ thetas, long long theta_stride, Spec spec,
               const float* __restrict__ X, const float* __restrict__ alpha,
               const int* __restrict__ n_real_p, int n_pad, int d, int B, int wb,
               const __grid_constant__ CUtensorMap out_map) {
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = smem_raw + (((1024 - (smem_u32(smem_raw) & 1023)) & 1023) >> 2);
  float* sa = smem;                                  // staging: tile (ti, tj)
  float* st = sa + kTileFloats;                      // the same values as tile (tj, ti)
  float* op = st + kTileFloats;                      // [kPoints][kOpStride]
  float* nrm = op + kPoints * kOpStride;             // [2][kPoints], by step parity
  const int pstride = params_stride(d);
  float* par = nrm + 2 * kPoints;                    // [2][pstride], by step parity
  float* ctr = par + 2 * pstride;                    // [pstride]: the centre
  // mbarriers: X loaded; the staging tiles full (the computing threads
  // arrive); the staging tiles free again (the storing warp arrives)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(ctr + pstride);
  const uint32_t x_bar = smem_u32(bar), full_bar = smem_u32(bar + 1), free_bar = smem_u32(bar + 2);
  float* xs = reinterpret_cast<float*>(bar + 4);     // [n_pad][d] when resident

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2;  // the MMA fragments' group and thread in group
  const int t4 = lane & 3;
  const int wr = warp >> 2;  // the warp's sub-tile: rows 32 wr, columns 32 wc
  const int wc = warp & 3;
  const int side = (n_pad + kTile - 1) / kTile;
  const int n_tiles = side * (side + 1) / 2;  // the tiles on and below the diagonal
  const int n_units = ((B + wb - 1) / wb) * n_tiles;
  const int n_chunks = (d + kKc - 1) / kKc;
  const int off = spec.has_const ? 1 : 0;
  const float* src = kResident ? xs : X;

  // thetas as K1 reads them: slot k < d is a log lengthscale, d the log
  // amplitude, d + 1 the log noise; and the parameter formed from it
  auto fetch_theta = [&](int b, int k) -> float {
    const float* th = thetas + (long long)b * theta_stride;
    if (k < d) return th[off + (spec.n_ls == 1 ? 0 : k)];
    if (k == d) return spec.has_const ? th[0] : 0.0f;
    return spec.has_white ? th[off + spec.n_ls] : 0.0f;
  };
  auto param_of = [&](int k, float t) -> float {
    if (k < d) return expf(-t);
    if (k == d) return spec.has_const ? expf(t) : 1.0f;
    return spec.has_white ? expf(t) : 0.0f;
  };
  // a walker's parameter row from this thread's prefetched theta (slot tid)
  auto write_params = [&](float* row, int b, float th_tid) {
    if (tid < d + 2) row[tid] = param_of(tid, th_tid);
    for (int k = tid + kThreads; k < d + 2; k += kThreads) row[k] = param_of(k, fetch_theta(b, k));
  };
  auto walker = [&](int u, int w) { return (u / n_tiles) * wb + w; };
  // unit u's tile (ti, tj), ti >= tj: row0 = 128 ti, col0 = 128 tj
  auto tile_of = [&](int u, int& row0, int& col0) {
    const int t = u % n_tiles;
    int ti = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    while (ti * (ti + 1) / 2 > t) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    row0 = ti * kTile;
    col0 = (t - ti * (ti + 1) / 2) * kTile;
  };
  // this lane's raw X of chunk c of unit u: element e = lane + 32 i of the
  // warp's 16 points x (8 or 16) dimensions, zero past d and past n_pad.
  // A lane's dimension, k = lane % (8 or 16), is the same for every i.
  auto load_raw = [&](float (&raw)[kRawPerLane], int u, int c) {
    int row0, col0;
    tile_of(u, row0, col0);
    const int k0 = c * kKc, kc = min(kKc, d - k0), lg = kc > 8 ? 4 : 3;
    const int k = lane & ((1 << lg) - 1);
#pragma unroll
    for (int i = 0; i < kRawPerLane; ++i) {
      const int q = (lane >> lg) + i * (32 >> lg);
      const int p = warp * kPtsPerWarp + q;
      const int gp = p < kTile ? row0 + p : col0 + p - kTile;
      raw[i] = q < kPtsPerWarp && k < kc && gp < n_pad ? src[(long long)gp * d + k0 + k] : 0.0f;
    }
  };

  if (tid == 0) {
    mbarrier_init(x_bar, 1);
    mbarrier_init(full_bar, kThreads);
    mbarrier_init(free_bar, 1);
    fence_proxy_async();
  }
  __syncthreads();
  if (kResident && tid == 0) bulk_load(smem_u32(xs), X, (uint32_t)(4LL * n_pad * d), x_bar);
  int u = blockIdx.x, w = 0;

  if (warp == kWarps) {
    // the storing warp (its lane 0): each step's two tiles as 4 TMA boxes
    // each; its waits for the TMA to read them hold up no computing warp
    if (lane == 0) mbarrier_arrive(free_bar);  // the staging tiles start free
    for (int s = 0; u < n_units; ++s) {
      int row0, col0;
      tile_of(u, row0, col0);
      const int b = walker(u, w);
      if (lane == 0) {
        mbarrier_wait(full_bar, s & 1);
#pragma unroll
        for (int box = 0; box < kTile / kBox; ++box) {
          tensor_store(&out_map, smem_u32(sa + box * kTile * kBox), col0 + box * kBox, row0, b);
          if (row0 != col0) {
            tensor_store(&out_map, smem_u32(st + box * kTile * kBox), row0 + box * kBox, col0, b);
          }
        }
        bulk_commit();
        bulk_wait_read_all();
        mbarrier_arrive(free_bar);
      }
      if (++w >= min(wb, B - (u / n_tiles) * wb)) {
        w = 0;
        u += gridDim.x;
      }
    }
    bulk_wait_all();
    return;
  }

  bool n_real_bad;
  const int n_real = load_n_real(n_real_p, n_pad, n_real_bad);
  write_params(par, walker(u, 0), tid < d + 2 ? fetch_theta(walker(u, 0), tid) : 0.0f);
  if (kResident) mbarrier_wait(x_bar, 0);
  // the centre: the mean of X's first 64 rows, a warp per dimension in a
  // fixed order (every block gets the same floats)
  for (int k = warp; k < d; k += kWarps) {
    float sum = 0.0f;
    for (int r = lane; r < kCentreRows; r += 32) sum += src[(long long)r * d + k];
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) ctr[k] = sum * (1.0f / kCentreRows);
  }
  named_barrier(1, kThreads);  // the computing threads only, from here on

  float raw[kRawPerLane];
  load_raw(raw, u, 0);
  for (int s = 0; u < n_units; ++s) {
    int row0, col0;
    tile_of(u, row0, col0);
    const bool diag = row0 == col0;
    const float* pc = par + (s & 1) * pstride;
    int un = u, wn = w + 1;  // the next step
    if (wn >= min(wb, B - (u / n_tiles) * wb)) {
      wn = 0;
      un += gridDim.x;
    }
    // the next step's theta for slot tid: in flight during this step's prep
    const float th_next = un < n_units && tid < d + 2 ? fetch_theta(walker(un, wn), tid) : 0.0f;

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    float nacc = 0.0f;  // lanes < 16: the norm of point 16 warp + lane

    for (int c = 0; c < n_chunks; ++c) {
      const int k0 = c * kKc, kc = min(kKc, d - k0), lg = kc > 8 ? 4 : 3;
      // scale the chunk into the operands, zero-padded to 1 << lg
      {
        const int k = lane & ((1 << lg) - 1);
        const float cen = k < kc ? ctr[k0 + k] : 0.0f, ils = k < kc ? pc[k0 + k] : 0.0f;
#pragma unroll
        for (int i = 0; i < kRawPerLane; ++i) {
          const int q = (lane >> lg) + i * (32 >> lg);
          if (q < kPtsPerWarp) op[(warp * kPtsPerWarp + q) * kOpStride + k] = (raw[i] - cen) * ils;
        }
      }
      __syncwarp();
      if (lane < kPtsPerWarp) {
        const float* pr = op + (warp * kPtsPerWarp + lane) * kOpStride;
        for (int k = 0; k < (1 << lg); k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(pr + k);
          nacc = fmaf(v.x, v.x, nacc);
          nacc = fmaf(v.y, v.y, nacc);
          nacc = fmaf(v.z, v.z, nacc);
          nacc = fmaf(v.w, v.w, nacc);
        }
        if (c == n_chunks - 1) nrm[(s & 1) * kPoints + warp * kPtsPerWarp + lane] = nacc;
      }
      named_barrier(1, kThreads);  // the operands (and the norms) are written

      // the next step's parameters: its row was last read in the step
      // before this one, which every thread finished before this barrier
      if (c == 0 && un < n_units) write_params(par + ((s + 1) & 1) * pstride, walker(un, wn), th_next);
      // the next chunk's raw X, or the next step's where its unit differs
      if (c + 1 < n_chunks) {
        load_raw(raw, u, c + 1);
      } else if (un < n_units && (un != u || n_chunks > 1)) {
        load_raw(raw, un, 0);
      }

#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ks == 1 && lg == 3) break;
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* a = op + (wr * 32 + mt * 16 + g8) * kOpStride + ks * 8 + t4;
          const float x[4] = {a[0], a[8 * kOpStride], a[4], a[8 * kOpStride + 4]};
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(x[j], ah[mt][j], al[mt][j]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* bp = op + (kTile + wc * 32 + nt * 8 + g8) * kOpStride + ks * 8 + t4;
          split_tf32(bp[0], bh[nt][0], bl[nt][0]);
          split_tf32(bp[4], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (!kOnePass) {
              mma_tf32(acc[mt][nt], al[mt], bh[nt]);
              mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
            }
            mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
          }
        }
      }
      named_barrier(1, kThreads);  // the operands are read
    }
    mbarrier_wait(free_bar, s & 1);  // the step before's rows have left the staging tiles

    // the epilogue: tile (ti, tj) into sa, row-major, and the same values
    // transposed into st, tile (tj, ti); a diagonal tile computes its lower
    // triangle and mirrors it into its upper one
    const float* ns = nrm + (s & 1) * kPoints;  // the step before's epilogue may still read the other
    const float amp = pc[d], noise = pc[d + 1];
    // kind 0: a tile off the diagonal inside the real block (no mask);
    // 1: off the diagonal, masked; 2: on the diagonal. Each is its own
    // straight-line code.
    auto epilogue = [&](auto kind_c) {
      constexpr int kind = decltype(kind_c)::value;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr * 32 + mt * 16 + g8 + 8 * h;
          const int grow = row0 + r;
          const float ni = ns[r];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int cl = wc * 32 + nt * 8 + 2 * t4;
            float v[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int gcol = col0 + cl + q;
              float d2 = ni + ns[kTile + cl + q] - 2.0f * acc[mt][nt][2 * h + q];
              d2 = d2 < 0.0f ? 0.0f : d2;  // keeps NaN, like jnp.maximum
              if (kind == 2 && grow == gcol) d2 = 0.0f;
              float val = amp * matern<kNu>(d2);
              if (kind != 0) {
                const bool real = grow < n_real && gcol < n_real;
                val = real ? val : 0.0f;
                if (kind == 2 && grow == gcol) val = real ? val + noise + alpha[grow] : 1.0f;
                if (n_real_bad) val = nan_f32();
              }
              v[q] = val;
            }
            if (kind != 2) {
              *reinterpret_cast<float2*>(sa + staged(r, cl)) = make_float2(v[0], v[1]);
              st[staged(cl, r)] = v[0];
              st[staged(cl + 1, r)] = v[1];
            } else {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                if (r >= cl + q) sa[staged(r, cl + q)] = v[q];
                if (r > cl + q) sa[staged(cl + q, r)] = v[q];
              }
            }
          }
        }
      }
    };
    if (diag) {
      epilogue(std::integral_constant<int, 2>());
    } else if (row0 + kTile <= n_real && col0 + kTile <= n_real) {
      epilogue(std::integral_constant<int, 0>());
    } else {
      epilogue(std::integral_constant<int, 1>());
    }
    fence_proxy_async();  // the generic writes, before the TMA reads them
    mbarrier_arrive(full_bar);
    u = un;
    w = wn;
  }
}

using WbKernel = void (*)(const float*, long long, Spec, const float*, const float*, const int*,
                          int, int, int, int, const CUtensorMap);

template <bool kResident, bool kOnePass>
WbKernel wb_kernel_nu(int nu_code) {
  return nu_code == 0   ? gram_wb_kernel<0, kResident, kOnePass>
         : nu_code == 1 ? gram_wb_kernel<1, kResident, kOnePass>
         : nu_code == 2 ? gram_wb_kernel<2, kResident, kOnePass>
                        : gram_wb_kernel<3, kResident, kOnePass>;
}

WbKernel wb_kernel_for(int nu_code, bool resident, bool one_pass) {
  return resident ? (one_pass ? wb_kernel_nu<true, true>(nu_code) : wb_kernel_nu<true, false>(nu_code))
                  : (one_pass ? wb_kernel_nu<false, true>(nu_code)
                              : wb_kernel_nu<false, false>(nu_code));
}

struct WbPlan {
  WbKernel kernel;
  long long smem;     // dynamic shared memory per block, bytes
  int resident;       // 1: the whole X sits in shared memory
  int blocks_per_sm;  // from the occupancy calculator
  int grid;           // blocks launched: min(units, blocks_per_sm x SMs)
  int units;          // (walker groups of wb) x 128-tiles on and below the diagonal
};

int wb_plan(int nu_code, int B, int n_pad, int d, int wb, bool one_pass, WbPlan* p) {
  if (B <= 0 || wb < 1 || n_pad <= 0 || n_pad % 64 || d <= 0 || nu_code < 0 || nu_code > 3) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long fixed = kFixedBytes + 12LL * params_stride(d);  // 2 parameter rows, the centre
  const long long x_bytes = 4LL * n_pad * d;
  p->resident = fixed + x_bytes <= optin;
  p->smem = fixed + (p->resident ? x_bytes : 0);
  const long long side = (n_pad + kTile - 1) / kTile;
  const long long units = (long long)((B + wb - 1) / wb) * (side * (side + 1) / 2);
  if (p->smem > optin || units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p->units = (int)units;
  p->kernel = wb_kernel_for(nu_code, p->resident, one_pass);
  err = cudaFuncSetAttribute((const void*)p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p->smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->blocks_per_sm, p->kernel,
                                                        kBlockThreads, (size_t)p->smem);
  }
  if (err != cudaSuccess) return (int)err;
  if (p->blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  p->grid = (int)(units < (long long)p->blocks_per_sm * sms ? units
                                                            : (long long)p->blocks_per_sm * sms);
  return 0;
}

// the gram (B, n_pad, n_pad) as a 3-D tensor map for the TMA stores: boxes
// of kBox columns x kTile rows of one walker, 128-byte swizzle. The
// encoder is the driver's, reached through the runtime (the library does
// not link libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_out_map(float* out, int B, int n_pad, CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)n_pad, (cuuint64_t)n_pad, (cuuint64_t)B};
  const cuuint64_t strides[2] = {4ull * n_pad, 4ull * n_pad * n_pad};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {kBox, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, out, dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_wb(bool one_pass, const float* thetas, long long theta_stride, int has_const,
              int has_white, int n_ls, const float* X, long long x_walker_stride,
              const float* alpha, const int* n_real, int B, int n_pad, int d, int nu_code,
              int wb, float* out, void* stream) {
  if (x_walker_stride != 0 || !(n_ls == 1 || n_ls == d)) {
    return (int)cudaErrorInvalidValue;
  }
  WbPlan p;
  const int err = wb_plan(nu_code, B, n_pad, d, wb, one_pass, &p);
  if (err) return err;
  if (p.resident && (reinterpret_cast<uintptr_t>(X) & 15)) {
    return (int)cudaErrorMisalignedAddress;  // the bulk copy needs 16-byte alignment
  }
  CUtensorMap map;
  const int map_err = encode_out_map(out, B, n_pad, &map);
  if (map_err) return map_err;
  const Spec spec{has_const, has_white, n_ls};
  p.kernel<<<p.grid, kBlockThreads, (size_t)p.smem, (cudaStream_t)stream>>>(
      thetas, theta_stride, spec, X, alpha, n_real, n_pad, d, B, wb, map);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: K1's arguments plus wb (the walkers of a unit), shared X only
// (x_walker_stride 0, X 16-byte aligned); n_pad a multiple of 64; n_real
// points to one int on the device.
extern "C" int bask_gram_wb_f32(const float* thetas, long long theta_stride, int has_const,
                                int has_white, int n_ls, const float* X,
                                long long x_walker_stride, const float* alpha, const int* n_real,
                                int B, int n_pad, int d, int nu_code, int wb, float* out,
                                void* stream) {
  return launch_wb(false, thetas, theta_stride, has_const, has_white, n_ls, X, x_walker_stride,
                   alpha, n_real, B, n_pad, d, nu_code, wb, out, stream);
}

// The same kernel with the cross term in one-pass TF32 (hi.hi only): a
// control for the precision checks, on no path of the package.
extern "C" int bask_gram_wb_tf32_control_f32(const float* thetas, long long theta_stride,
                                             int has_const, int has_white, int n_ls,
                                             const float* X, long long x_walker_stride,
                                             const float* alpha, const int* n_real, int B,
                                             int n_pad, int d, int nu_code, int wb, float* out,
                                             void* stream) {
  return launch_wb(true, thetas, theta_stride, has_const, has_white, n_ls, X, x_walker_stride,
                   alpha, n_real, B, n_pad, d, nu_code, wb, out, stream);
}

// K4's launch plan on the current device, into info[0..4]: dynamic shared
// memory per block (bytes), X resident (1) or read per unit (0), resident
// blocks per SM, grid blocks, units.
extern "C" int bask_gram_wb_info(int nu_code, int B, int n_pad, int d, int wb, int* info) {
  WbPlan p;
  const int err = wb_plan(nu_code, B, n_pad, d, wb, false, &p);
  if (err) return err;
  info[0] = (int)p.smem;
  info[1] = p.resident;
  info[2] = p.blocks_per_sm;
  info[3] = p.grid;
  info[4] = p.units;
  return 0;
}
