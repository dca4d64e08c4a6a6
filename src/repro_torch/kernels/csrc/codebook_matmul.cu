// Matmul with on-the-fly codebook dequantization (paper C3) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/codebook_matmul.py (entry point `codebook_matmul`, the
// `pl.pallas_call` there):
//   out = x @ w,  w[k, n] = codebook[idx[k, n]]
// with x (M, K) f32 or bf16 (widened to f32 on load), idx (K, N) int8 and a
// per-tensor codebook of at most 16 levels.  Weights are dequantized inside
// the kernel by compare-and-select against the levels held in shared
// memory, as the reference's `_dequant_tile` does, so an index outside
// [0, L) contributes 0; the f32 weights never exist in device memory.
//
// Design (first, simple version): a SIMT tiled product on the CUDA cores.
// One block of 256 threads per 64 x 64 output tile, each thread a 4 x 4
// patch.  Per 16-deep K-tile the block stages the x tile (transposed) and
// the dequantized weight tile in shared memory, sums the 16 products of
// each output in f32 and adds that tile sum into an f64 accumulator, so
// the result is within rounding of the exact product whatever K is (the
// reference accumulates f32 tiles in f32; a long f32 chain drifted 1.1e-4
// from a matmul in fused_timestep.cu's first card run).  TF32 and the
// tensor cores stay unused: the reference computes full-f32 dots.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores): the
// operations.  Layer 1 at M = 640 (2312 -> 4096) is 12.1 GFLOP, about
// 180 us; its bytes (5.9 MB of x, 9.5 MB of indexes, 10.5 MB out) take
// about 8 us.  A SIMT tile of this size reaches a fraction of that rate;
// `wgmma` on bf16 splits of x and w, or register tiling with vector
// loads, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int kMaxLevels = 16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) codebook_matmul_kernel(
    const T* __restrict__ x,             // (M, K)
    const int8_t* __restrict__ idx,      // (K, N)
    const float* __restrict__ codebook,  // (n_levels,)
    float* __restrict__ out,             // (M, N)
    int m, int k, int n, int n_levels) {
  __shared__ float xs[kBK][kBM + 4];  // x tile, k-major
  __shared__ float ws[kBK][kBN + 4];  // dequantized weight tile
  __shared__ float levels[kMaxLevels];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  if (tid < kMaxLevels) levels[tid] = tid < n_levels ? codebook[tid] : 0.f;
  __syncthreads();

  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gk = k0 + c;
      xs[c][r] = (gr < m && gk < k) ? widen(x[(size_t)gr * k + gk]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gc = col0 + c;
      const int li = (gk < k && gc < n) ? (int)idx[(size_t)gk * n + gc] : -1;
      float w = 0.f;  // levels past n_levels are 0 too
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) w = li == l ? levels[l] : w;
      ws[r][c] = w;
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty * 4 + i];
        b[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += (double)part[i][j];
    __syncthreads();
  }

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

template <typename T>
cudaError_t run(const void* x, const void* idx, const void* codebook,
                void* out, int m, int k, int n, int n_levels,
                cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k < 0 || n_levels <= 0 || n_levels > kMaxLevels)
    return cudaErrorInvalidValue;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  codebook_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(idx),
      static_cast<const float*>(codebook), static_cast<float*>(out), m, k, n,
      n_levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) f32, or bf16 when x_bf16 = 1; idx (K, N) int8; codebook
// (n_levels,) f32 with n_levels <= 16; out (M, N) f32.
int codebook_matmul_launch(const void* x, int x_bf16, const void* idx,
                           const void* codebook, void* out, int m, int k,
                           int n, int n_levels, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)run<__nv_bfloat16>(x, idx, codebook, out, m, k, n, n_levels,
                                   s);
  return (int)run<float>(x, idx, codebook, out, m, k, n, n_levels, s);
}

const char* codebook_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
