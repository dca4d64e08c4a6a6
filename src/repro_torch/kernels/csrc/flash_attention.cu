// Flash attention forward (tiled online-softmax SDPA) for NVIDIA Hopper
// (sm_90a): a tensor-core kernel for bf16 at head dims 64 and 128, and a
// SIMT kernel for f32 (every head dim) and bf16 at head dims 16 and 32.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py (entry point `flash_attention`, the
// `pl.pallas_call` there), and computes what it computes:
//   s   = (q . k^T) * hd^-0.5 in f32; causal: s = -1e30 where col > row
//         (absolute indices, so T may exceed S; the finite NEG_INF, so a
//         fully masked tile adds exactly 0);
//   online max m and sum l in f32, p = exp(s - m_new), alpha =
//   exp(m_prev - m_new), l = l * alpha + sum(p), acc = acc * alpha + p'.v
//   with p' = p rounded to the input type (l sums the unrounded p); out =
//   acc / max(l, 1e-30) in the input type.
// GQA is read in place: query head g of (B*H) reads kv row
// (g / H) * KV + (g % H) / (H / KV); no repeat of K/V is materialized.
//
// Bound at the served prefill shape (granite-3-2b, B 4, H 32, KV 8,
// S = T = 512, hd 64, bf16, causal) on an H100 SXM: q + o 2 x 8.39 MB and
// k + v 4.19 MB read once, 20.97 MB / 3.35 TB/s = 6.3 us; 4.29 GFLOP of
// the causal half / 989 TFLOP/s = 4.3 us; so 6.3 us, set by bytes.
//
// Tensor-core kernel (`flash_attention_wgmma_kernel`, bf16, hd 64 and 128).  A
// block of 288 threads takes 128 query rows of one (b, h): two consumer
// warpgroups of 64 rows each and one producer warp.  The producer's lane 0
// loads the q tile once and then the 64-key K and V tiles by TMA (tiled tensor
// maps over q as (B*H*S, hd) rows and k, v as (B*KV*T, hd) rows, 128-byte
// swizzle, hd split into 64-column panels) into a three-stage ring, each stage
// with a full and an empty mbarrier.  Each consumer warpgroup computes S = Q
// K^T with `wgmma` m64n64k16 (both operands K-major in shared memory, f32
// accumulators), runs the online softmax on its accumulator fragment (a thread
// holds parts of two rows; a row's max and sum take two shuffles across its
// quad, and l is reduced across the quad only at the end), converts p to bf16
// pairs, which are exactly the register A fragment of the next `wgmma`, and
// computes O += P V with V as the transposed (MN-major) B operand, one
// m64n64k16 per 64 head dims; that product is waited for together with the next
// tile's S.  No score tile passes through shared memory.  The softmax works in
// base 2: with c = hd^-0.5 * log2(e), p = 2^(s c - m c) by one FFMA and the
// SFU's `ex2.approx` (relative error about 2^-22), which is exp(s - m) to
// within rounding; the row max is taken on the unscaled scores.  Causal: a
// block stops at the key tile holding its last row, a warpgroup skips the tiles
// past its own diagonal (it still releases them), and only the diagonal tile is
// masked, element by element.  The heaviest query tiles of all heads are
// dispatched first (the query tile is the grid's slow dimension).  The tensor
// maps are encoded on the host per call (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so no -lcuda) and passed as __grid_constant__
// parameters: a graph captures them with the launch.
//
// SIMT kernel (`flash_attention_kernel`).  One block of 256 threads per
// (b*h, 64 query rows); the q tile and each 64-key K/V tile are staged in
// shared memory as f32 (bf16 inputs widened on load).  Thread (ty, tx) of
// a 16 x 16 grid owns the score rows ty + 16 i and columns tx + 16 j (4 x
// 4), then the output rows ty + 16 i and head dims tx + 16 j; the score
// tile goes through shared memory, where four threads per row take its
// max and sum with shuffles.  Row strides of hd + 1 (q, k) and 65 (scores)
// keep the column walks free of bank conflicts.  f32 stays on this kernel:
// the reference computes full-f32 dots, and a tensor-core f32 path (TF32)
// would compute another function.  It runs on the f32 FMA units (67
// TFLOP/s), two shared-memory loads per FMA pair.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
    default:
      break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16: the wgmma kernel
    if (hd == 64)
      return launch_typed<T, 64>(q, k, v, o, B, H, KV, S, Tlen, causal, scale,
                                 stream);
    if (hd == 128)
      return launch_typed<T, 128>(q, k, v, o, B, H, KV, S, Tlen, causal,
                                  scale, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// tensor-core kernel: bf16, hd 64 and 128
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBQ = 128;            // two consumer warpgroups of 64 rows
constexpr int kBK = 64;             // keys per K/V tile
constexpr int kStages = 3;          // K/V ring
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + one producer warp
constexpr int kRowBytes = 128;      // a swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Layout {
  static constexpr int kPanels = HD / 64;          // 64-column panels
  static constexpr int kQPanel = kBQ * kRowBytes;  // bytes
  static constexpr int kKVPanel = kBK * kRowBytes;
  static constexpr int kQ = kPanels * kQPanel;
  static constexpr int kStage = 2 * kPanels * kKVPanel;  // K panels, V panels
  static constexpr int kBytes = kQ + kStages * kStage + 1024;  // + alignment
};

// Two blocks share an SM at hd 64 (the launch bounds cap the registers
// for that); at hd 128 the O accumulators leave room for one.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
    flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    int H, int KV, int S, int Tlen, int causal, float scale_log2) {
  using L = Layout<HD>;
  using namespace hopper;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], q_full;
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* kvs = smem + L::kQ;

  // the query tile in the grid's slow dimension, heaviest first: every
  // head's last tile is dispatched before any head's second-to-last
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int g = blockIdx.x;  // b * H + h
  const int kv_row = (g / H) * KV + (g % H) / (H / KV);
  int n_tiles = Tlen / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);  // lane 0 of each consumer warp
    }
    mbar_init(&q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer
    if (lane == 0) {
      mbar_arrive_expect_tx(&q_full, L::kQ);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_2d(qs + p * L::kQPanel, &qmap, &q_full, 64 * p, g * S + q0);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* st = kvs + s * L::kStage;
        mbar_arrive_expect_tx(&full[s], L::kStage);
        const int row = kv_row * Tlen + kt * kBK;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_2d(st + p * L::kKVPanel, &kmap, &full[s], 64 * p, row);
          tma_load_2d(st + (L::kPanels + p) * L::kKVPanel, &vmap, &full[s],
                      64 * p, row);
        }
      }
    }
    return;
  }

  // consumer warpgroup `wgi`: query rows wrow0 .. wrow0 + 63; this thread
  // holds rows r0 (j = 0) and r0 + 8 (j = 1) of every fragment
  const int wgi = warp / 4;
  const int wrow0 = q0 + 64 * wgi;
  const int r0 = wrow0 + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  int last = n_tiles - 1;
  if (causal) last = min(last, (wrow0 + 63) / kBK);
  const uint8_t* qw = qs + 64 * wgi * kRowBytes;

  float acc[L::kPanels][32];
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
  // m in raw score units; the exponent is 2^(s * c - m * c), c = scale *
  // log2(e), one FFMA and one ex2 per element
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int pending = -1;  // the stage whose PV product may still be in flight
  // p rounded to bf16, the PV product's A fragment; it stays live (and
  // its registers unused by anything else) until that product is waited for
  uint32_t pa[4][4] = {};
  mbar_wait(&q_full, 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    if (kt > last) {  // past this warpgroup's diagonal: release it unread
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* ks = kvs + s * L::kStage;
    const uint8_t* vs = ks + L::kPanels * L::kKVPanel;
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * L::kQPanel + (kk % 4) * 32;
      const int koff = (kk / 4) * L::kKVPanel + (kk % 4) * 32;
      wgmma_m64n64k16_ss(sc, desc_sw128(qw + off), desc_sw128(ks + koff),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // this S, and the previous tile's PV
    fence_regs(sc);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) fence_regs(acc[p]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);

    if (causal && kt * kBK + kBK - 1 > wrow0) {  // the diagonal tile
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (kt * kBK + 8 * (e / 4) + c0 + e % 2 > r0 + 8 * ((e / 2) % 2))
          sc[e] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
    float alpha[2], ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      alpha[j] = ex2((m[j] - m_new) * scale_log2);
      m[j] = m_new;
      ms[j] = m_new * scale_log2;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = (e / 2) % 2;
      const float p = ex2(fmaf(sc[e], scale_log2, -ms[j]));
      sum[j] += p;
      sc[e] = p;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + sum[j];
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[p][e] *= alpha[(e / 2) % 2];

    // the S fragment of keys 16 kk .. 16 kk + 15 is the A fragment of the
    // PV product's k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs_tb(
            acc[p], pa[kk],
            desc_sw128(vs + p * L::kKVPanel + kk * 16 * kRowBytes, 1024,
                       1024));
    wgmma_commit();  // waited for with the next tile's S, or below
    pending = s;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p) fence_regs(acc[p]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
  if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);

  // out = acc / max(l, 1e-30), l summed across the quad
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    l[j] = fmaxf(l[j], 1e-30f);
  }
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int j = (e / 2) % 2;
      const size_t row = (size_t)g * S + r0 + 8 * j;
      __nv_bfloat162 val =
          __floats2bfloat162_rn(acc[p][e] / l[j], acc[p][e + 1] / l[j]);
      *reinterpret_cast<__nv_bfloat162*>(
          o + row * HD + 64 * p + 8 * (e / 4) + c0) = val;
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, hd) bf16 row-major matrix read in boxes of (box_rows, 64)
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base,
            uint64_t rows, int hd, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)hd, rows};
  const cuuint64_t strides[1] = {(cuuint64_t)hd * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int Tlen, int causal,
                   float scale, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  if (!encode(enc, &qmap, q, (uint64_t)B * H * S, HD, kBQ) ||
      !encode(enc, &kmap, k, (uint64_t)B * KV * Tlen, HD, kBK) ||
      !encode(enc, &vmap, v, (uint64_t)B * KV * Tlen, HD, kBK))
    return cudaErrorInvalidValue;
  const int bytes = Layout<HD>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, S / kBQ);
  flash_attention_wgmma_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), H, KV, S, Tlen,
      causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// q (B, H, S, hd), k / v (B, KV, T, hd), o (B, H, S, hd), all contiguous
// and of one type (f32, or bf16 when is_bf16 at hd 16 or 32).  The caller
// checks S % 64 == 0, T % 64 == 0, H % KV == 0 and B * H <= 65535.
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

// The tensor-core kernel: bf16 q, k, v, o as above, hd 64 or 128, every
// pointer 16-byte aligned, S and T multiples of 128.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int KV, int S,
                                 int Tlen, int hd, int causal, float scale,
                                 void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return (int)wg::launch<64>(q, k, v, o, B, H, KV, S, Tlen, causal, scale,
                               st);
  if (hd == 128)
    return (int)wg::launch<128>(q, k, v, o, B, H, KV, S, Tlen, causal, scale,
                                st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
