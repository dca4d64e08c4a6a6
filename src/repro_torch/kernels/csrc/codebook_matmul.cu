// Matmul with on-the-fly codebook dequantization (paper C3) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/codebook_matmul.py (entry point `codebook_matmul`, the
// `pl.pallas_call` there):
//   out = x @ w,  w[k, n] = codebook[idx[k, n]]
// with x (M, K) f32 or bf16 (widened to f32 in the product), idx (K, N)
// int8 and a per-tensor codebook of at most 16 levels.  An index outside
// [0, L) contributes 0, as the reference's compare-and-select
// `_dequant_tile` gives; the f32 weights never exist in device memory.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores): the
// operations.  At the paper's network and one step (M = 32) the three
// layers are 0.88 GFLOP, 13.1 us; their bytes (9.5 MB of indexes at layer
// 1) take 4.1 us.  The tensor cores stay unused: x . w with f32 w is not a
// bf16 product, and the reference computes full-f32 dots (TF32 is off).
//
// Design.  A block of 256 threads computes a (BM, 64) output tile over one
// slice of K; BM is 32 when M <= 32 and 64 otherwise, so a one-step call
// fills its tiles.  The wrapper's `_plan` picks BM, the split of K and the
// slice length (a multiple of the 32-deep stage): the `split` blocks of a
// tile form a thread-block cluster, each sums its slice, and the cluster's
// first block adds the others' partial tiles through distributed shared
// memory in rank order, so the grid fills the card at M = 32 (layer 2
// gives 16 tiles for 132 SMs) and the result is the same in every run (no
// atomics).  Per 32-deep stage the x tile and the index tile arrive by
// 16-byte cp.async into a three-stage ring, so the next two stages are in
// flight during this one's arithmetic (shapes whose rows are not 16-byte
// aligned load element by element instead).  The index tile is
// dequantized once per stage through a 256-entry table in shared memory
// indexed by the byte as uint8: cb[l] for 0 <= l < L, 0 elsewhere,
// including 128..255, the negative int8 values; the x tile is widened to
// f32 and transposed in the same pass.  A thread owns 4 rows and 4
// columns, read per k as one float4 of x and one of w; at BM = 32 the
// block's two halves take alternate 16-deep parts of a stage and add their
// sums in a fixed order at the end.  The launch bounds hold a thread to
// 80 registers at BM = 64 (three blocks per SM) and 128 at BM = 32 (two;
// left free, the compiler takes more and one block fits, which measured
// slower at M = 32).  A thread sums 16 products in f32 and adds
// that sum into an f64 accumulator, partials add in f64 across the split,
// and the output is rounded once, so the result is within rounding of the
// exact product whatever K is.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;        // K rows per stage
constexpr int kSub = 16;       // f32 terms summed before the f64 add
constexpr int kStages = 3;     // cp.async ring: two stages in flight
constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;
constexpr int kMaxSplit = 8;   // portable cluster size

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A thread owns 4 rows x 4 columns of the (BM, 64) tile; the threads that
// cover the tile once form a group, and the block's groups (2 at BM = 32,
// 1 at BM = 64) take alternate 16-deep parts of each stage.  (8 rows per
// thread cost enough registers at BM = 64 that two blocks fit on an SM
// instead of three, which measured slower at M = 640.)
template <typename T, int BM>
struct Cfg {
  static constexpr int kGroupThreads = BM * kBN / 16;
  static constexpr int kGroups = kThreads / kGroupThreads;
  static constexpr int kXLd = kBK + 16 / sizeof(T);  // row, 16 B multiple
  static constexpr int kTLd = BM + 4;                // transposed x row
  static constexpr int kX = BM * kXLd * sizeof(T);   // one stage of x
  static constexpr int kIdx = kBK * kBN;             // one stage of indexes
  static constexpr int kW = kBK * kBN * 4;           // dequantized stage
  static constexpr int kXT = kBK * kTLd * 4;         // x stage, k-major f32
  static constexpr int kTable = 256 * 4;
  static constexpr int kLoop = kStages * (kX + kIdx) + kW + kXT + kTable;
  static constexpr int kPartial = BM * kBN * 8;      // f64 tile
  static constexpr int kBytes = kLoop > kPartial ? kLoop : kPartial;
  static_assert(kGroups * kGroupThreads == kThreads, "whole groups");
  static_assert((kBK / kSub) % kGroups == 0, "parts split evenly");
};

template <typename T, int BM, bool kVec>
__device__ __forceinline__ void load_stage(
    const T* __restrict__ x, const int8_t* __restrict__ idx, T* xs,
    int8_t* ids, int row0, int col0, int k0, int k_end, int m, int k, int n) {
  using C = Cfg<T, BM>;
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kXChunk = 16 / sizeof(T);  // elements per 16 bytes
    constexpr int kRowChunks = kBK / kXChunk;
    for (int c = tid; c < BM * kRowChunks; c += kThreads) {
      const int r = c / kRowChunks, e = (c % kRowChunks) * kXChunk;
      const int gr = row0 + r, gk = k0 + e;
      const bool ok = gr < m && gk < k_end;
      hopper::cp_async16(xs + r * C::kXLd + e,
                         ok ? x + (size_t)gr * k + gk : x, ok ? 16 : 0);
    }
    for (int c = tid; c < kBK * kBN / 16; c += kThreads) {
      const int r = c / (kBN / 16), e = (c % (kBN / 16)) * 16;
      const int gk = k0 + r, gc = col0 + e;
      const bool ok = gk < k_end && gc < n;
      hopper::cp_async16(ids + r * kBN + e,
                         ok ? idx + (size_t)gk * n + gc : idx, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gk = k0 + c;
      xs[r * C::kXLd + c] =
          (gr < m && gk < k_end) ? x[(size_t)gr * k + gk] : T(0.f);
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gc = col0 + c;
      ids[r * kBN + c] = (gk < k_end && gc < n) ? idx[(size_t)gk * n + gc] : 0;
    }
  }
}

template <typename T, int BM, bool kVec>
__global__ void __launch_bounds__(kThreads, BM == 64 ? 3 : 2)
    codebook_matmul_kernel(
    const T* __restrict__ x,             // (M, K)
    const int8_t* __restrict__ idx,      // (K, N)
    const float* __restrict__ codebook,  // (n_levels,)
    float* __restrict__ out,             // (M, N)
    int m, int k, int n, int n_levels, int split, int k_chunk) {
  using C = Cfg<T, BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* xs = reinterpret_cast<T*>(smem);
  int8_t* ids = reinterpret_cast<int8_t*>(smem + kStages * C::kX);
  float* ws = reinterpret_cast<float*>(smem + kStages * (C::kX + C::kIdx));
  float* xt = ws + kBK * kBN;
  float* table = xt + kBK * C::kTLd;
  double* partial = reinterpret_cast<double*>(smem);  // after the loop

  const int tid = threadIdx.x;
  const int grp = tid / C::kGroupThreads;
  const int gt = tid % C::kGroupThreads;
  const int tx = gt % 16, ty = gt / 16;
  const int rank = split > 1 ? (int)blockIdx.x % split : 0;
  const int col0 = (blockIdx.x / split) * kBN;
  const int row0 = blockIdx.y * BM;
  const int k0 = rank * k_chunk;
  const int k_end = min(k, k0 + k_chunk);
  const int n_stages = k_end > k0 ? (k_end - k0 + kBK - 1) / kBK : 0;

  table[tid] = tid < n_levels ? codebook[tid] : 0.f;  // byte as uint8

  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages)
      load_stage<T, BM, kVec>(x, idx, xs + s * (C::kX / sizeof(T)),
                              ids + s * C::kIdx, row0, col0, k0 + s * kBK,
                              k_end, m, k, n);
    hopper::cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    const int buf = st % kStages;
    hopper::cp_async_wait<kStages - 2>();  // stage st has landed
    __syncthreads();  // ... for every thread; stage st - 1 is not read
    {
      const int nxt = st + kStages - 1, nbuf = nxt % kStages;
      if (nxt < n_stages)
        load_stage<T, BM, kVec>(x, idx, xs + nbuf * (C::kX / sizeof(T)),
                                ids + nbuf * C::kIdx, row0, col0,
                                k0 + nxt * kBK, k_end, m, k, n);
      hopper::cp_async_commit();
    }

    // dequantize the stage (8 indexes per thread, one table load each)
    // and transpose x to k-major f32
    {
      const int e = tid * 8;
      const uint2 b = *reinterpret_cast<const uint2*>(ids + buf * C::kIdx + e);
      float4 lo, hi;
      lo.x = table[b.x & 0xff];
      lo.y = table[(b.x >> 8) & 0xff];
      lo.z = table[(b.x >> 16) & 0xff];
      lo.w = table[b.x >> 24];
      hi.x = table[b.y & 0xff];
      hi.y = table[(b.y >> 8) & 0xff];
      hi.z = table[(b.y >> 16) & 0xff];
      hi.w = table[b.y >> 24];
      *reinterpret_cast<float4*>(ws + e) = lo;
      *reinterpret_cast<float4*>(ws + e + 4) = hi;
      const T* xb = xs + buf * (C::kX / sizeof(T));
#pragma unroll
      for (int q = tid; q < BM * kBK; q += kThreads) {
        const int c = q % kBK, r = q / kBK;
        xt[c * C::kTLd + r] = widen(xb[r * C::kXLd + c]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kBK / kSub / C::kGroups; ++s) {
      const int kb = (s * C::kGroups + grp) * kSub;
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSub; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(
            xt + (kb + kk) * C::kTLd + ty * 4);
        const float4 w = *reinterpret_cast<const float4*>(
            ws + (kb + kk) * kBN + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[i][0] = fmaf(av[i], w.x, part[i][0]);
          part[i][1] = fmaf(av[i], w.y, part[i][1]);
          part[i][2] = fmaf(av[i], w.z, part[i][2]);
          part[i][3] = fmaf(av[i], w.w, part[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += (double)part[i][j];
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the f64 tiles from here

  // the groups' sums, added in group order into group 0
  if (C::kGroups > 1) {
    if (grp == 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          partial[(i * 4 + j) * C::kGroupThreads + gt] = acc[i][j];
    __syncthreads();
    if (grp == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += partial[(i * 4 + j) * C::kGroupThreads + gt];
  }

  if (split > 1) {
    // the cluster's partial tiles through distributed shared memory, added
    // in rank order into rank 0
    cg::cluster_group cluster = cg::this_cluster();
    if (grp == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          partial[(i * 4 + j) * C::kGroupThreads + gt] = acc[i][j];
    cluster.sync();
    if (rank == 0 && grp == 0) {
      for (int r = 1; r < split; ++r) {
        const double* other = cluster.map_shared_rank(partial, r);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += other[(i * 4 + j) * C::kGroupThreads + gt];
      }
    }
    cluster.sync();  // the others' shared memory stays until it is read
  }
  if (rank != 0 || grp != 0) return;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < n) out[(size_t)r * n + c] = (float)acc[i][j];
    }
  }
}

template <typename T, int BM, bool kVec>
cudaError_t launch(const void* x, const void* idx, const void* codebook,
                   void* out, int m, int k, int n, int n_levels, int split,
                   int k_chunk, cudaStream_t stream) {
  const dim3 grid(((n + kBN - 1) / kBN) * split, (m + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  constexpr int bytes = Cfg<T, BM>::kBytes;
  // above 48 KB a kernel must opt in; the attribute is per device, so it
  // is set on every launch (a host call allowed during graph capture)
  const cudaError_t err = cudaFuncSetAttribute(
      codebook_matmul_kernel<T, BM, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(
      &cfg, codebook_matmul_kernel<T, BM, kVec>, static_cast<const T*>(x),
      static_cast<const int8_t*>(idx), static_cast<const float*>(codebook),
      static_cast<float*>(out), m, k, n, n_levels, split, k_chunk);
}

template <typename T>
cudaError_t run(const void* x, const void* idx, const void* codebook,
                void* out, int m, int k, int n, int n_levels, int bm,
                int split, int k_chunk, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k < 0 || n_levels <= 0 || n_levels > kMaxLevels || split < 1 ||
      split > kMaxSplit || k_chunk <= 0 || k_chunk % kBK ||
      (long long)split * k_chunk < k)
    return cudaErrorInvalidValue;
  // 16-byte loads need 16-byte aligned rows and bases
  const bool vec = (k * sizeof(T)) % 16 == 0 && n % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  if (bm == 32)
    return vec ? launch<T, 32, true>(x, idx, codebook, out, m, k, n, n_levels,
                                     split, k_chunk, stream)
               : launch<T, 32, false>(x, idx, codebook, out, m, k, n,
                                      n_levels, split, k_chunk, stream);
  if (bm == 64)
    return vec ? launch<T, 64, true>(x, idx, codebook, out, m, k, n, n_levels,
                                     split, k_chunk, stream)
               : launch<T, 64, false>(x, idx, codebook, out, m, k, n,
                                      n_levels, split, k_chunk, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (M, K) f32, or bf16 when x_bf16 = 1; idx (K, N) int8; codebook
// (n_levels,) f32 with n_levels <= 16; out (M, N) f32.  The plan: row tile
// bm (32 or 64), a cluster of `split` blocks (1..8) along K, each over
// k_chunk rows of K (a multiple of 32, split * k_chunk >= K).
int codebook_matmul_launch(const void* x, int x_bf16, const void* idx,
                           const void* codebook, void* out, int m, int k,
                           int n, int n_levels, int bm, int split,
                           int k_chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)run<__nv_bfloat16>(x, idx, codebook, out, m, k, n, n_levels,
                                   bm, split, k_chunk, s);
  return (int)run<float>(x, idx, codebook, out, m, k, n, n_levels, bm, split,
                         k_chunk, s);
}

const char* codebook_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
