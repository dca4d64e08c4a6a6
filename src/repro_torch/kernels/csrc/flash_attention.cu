// Flash attention forward (tiled online-softmax SDPA) for NVIDIA Hopper
// (sm_90a), SIMT.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py (entry point `flash_attention`, the
// `pl.pallas_call` there), and computes what it computes:
//   s   = (q . k^T) * hd^-0.5 in f32; causal: s = -1e30 where col > row
//         (the finite NEG_INF, so a fully masked tile adds exactly 0);
//   online max m and sum l in f32, p = exp(s - m_new), alpha =
//   exp(m_prev - m_new), l = l * alpha + sum(p), acc = acc * alpha + p'.v
//   with p' = p rounded to the input type; out = acc / max(l, 1e-30) in
//   the input type.
// GQA is read in place: query head g of (B*H) reads kv row
// (g / H) * KV + (g % H) / (H / KV); no repeat of K/V is materialized.
//
// Design.  One block of 256 threads per (b*h, 64 query rows); the q tile
// and each 64-key K/V tile are staged in shared memory as f32 (bf16 inputs
// are widened on load).  Thread (ty, tx) of a 16 x 16 grid owns the score
// rows ty + 16 i and columns tx + 16 j (4 x 4), then the output rows
// ty + 16 i and head dims tx + 16 j; the score tile goes through shared
// memory, where four threads per row take its max and sum with shuffles.
// Row strides of hd + 1 (q, k) and 65 (scores) keep the column walks free
// of bank conflicts.  Causal blocks stop at the tile holding their last
// row (the reference also visits one fully masked tile, which adds 0) and
// the heaviest tiles are scheduled first.
//
// Bound at the served prefill shape (granite-3-2b, B 4, H 32, KV 8,
// S = T = 512, hd 64, bf16, causal) on an H100 SXM: q + o 2 x 8.39 MB and
// k + v 4.19 MB read once, 20.97 MB / 3.35 TB/s = 6.3 us; 4.29 GFLOP of
// the causal half / 989 TFLOP/s = 4.3 us; so 6.3 us, set by bytes.  This
// SIMT kernel does the products on the f32 FMA units (67 TFLOP/s), two
// shared-memory loads per FMA pair: it is bound by shared-memory traffic
// and the FMA rate, tens of times above the bound.  The tensor-core
// redesign (mma.sync, then wgmma fed by TMA) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "one tile loader for q and k/v");
static_assert(kBQ * 4 == kThreads, "four threads per row in the softmax");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
struct Smem {
  static constexpr int kQ = kBQ * (HD + 1);
  static constexpr int kK = kBK * (HD + 1);
  static constexpr int kV = kBK * HD;
  static constexpr int kS = kBQ * (kBK + 1);
  static constexpr size_t kBytes =
      (size_t)(kQ + kK + kV + kS + 3 * kBQ) * sizeof(float);
};

// A (64, HD) row-major tile into shared memory as f32, row stride `ld`.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst, int ld) {
  for (int e = threadIdx.x; e < kBK * HD; e += kThreads) {
    dst[(e / HD) * ld + e % HD] = to_f32(src[e]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int KV, int S,
    int Tlen, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<HD>::kQ;
  float* Vs = Ks + Smem<HD>::kK;
  float* Ss = Vs + Smem<HD>::kV;
  float* m_s = Ss + Smem<HD>::kS;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  constexpr int kDJ = HD / 16;   // head dims per thread: tx + 16 j

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const long long g = blockIdx.y;                      // b * H + h
  const long long kv_row = (g / H) * KV + (g % H) / (H / KV);
  const T* kg = k + kv_row * Tlen * HD;
  const T* vg = v + kv_row * Tlen * HD;
  const long long q_off = (g * S + q0) * HD;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  load_tile<T, HD>(q + q_off, Qs, HD + 1);
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;

  int n_tiles = Tlen / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, HD>(kg + (long long)kt * kBK * HD, Ks, HD + 1);
    load_tile<T, HD>(vg + (long long)kt * kBK * HD, Vs, HD);
    __syncthreads();

    // scores of rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kt * kBK + c > q0 + r) x = kNegInf;
        Ss[r * (kBK + 1) + c] = x;
      }
    __syncthreads();

    // online softmax: four threads per row, 16 columns each
    {
      const int r = tid / 4, part = tid % 4;
      float* srow = Ss + r * (kBK + 1) + part * 16;
      const float m_prev = m_s[r];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        srow[c] = to_f32(from_f32<T>(p));   // p rounded to the input type
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      // every lane of the row read m_s[r] before the shuffles above
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this tile
    float pv[4][kDJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDJ; ++j) pv[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pa[4], vb[kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ss[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) vb[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j) pv[i][j] = fmaf(pa[i], vb[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] = acc[i][j] * alpha + pv[i][j];
    }
  }

  __syncthreads();
  T* og = o + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDJ; ++j)
      og[r * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int S, int Tlen, int causal,
                         float scale, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in; the
  // attribute is per device, so it is set on every launch (a host call
  // that is allowed during CUDA-graph capture)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<HD>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBQ, B * H);
  flash_attention_kernel<T, HD><<<grid, kThreads, Smem<HD>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, Tlen, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int H, int KV, int S, int Tlen,
                      int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_typed<T, 16>(q, k, v, o, B, H, KV, S, Tlen, causal, scale,
                                 stream);
    case 32:
      return launch_typed<T, 32>(q, k, v, o, B, H, KV, S, Tlen, causal, scale,
                                 stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, B, H, KV, S, Tlen, causal, scale,
                                 stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, o, B, H, KV, S, Tlen, causal,
                                  scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, S, hd), k / v (B, KV, T, hd), o (B, H, S, hd), all contiguous
// and of one type (bf16 when is_bf16, else f32).  The caller checks
// S % 64 == 0, T % 64 == 0, H % KV == 0, hd in {16, 32, 64, 128} and
// B * H <= 65535.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int KV, int S, int Tlen,
                           int hd, int causal, int is_bf16, float scale,
                           void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, S, Tlen,
                                         causal, scale, st);
  return (int)launch_hd<float>(hd, q, k, v, o, B, H, KV, S, Tlen, causal,
                               scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
