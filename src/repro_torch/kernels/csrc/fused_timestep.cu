// One fused layer-timestep of the simulated chip for NVIDIA Hopper (sm_90a):
// ZSPE spike-word scan -> codebook (or dense) synaptic integration ->
// partial-update LIF, with membrane state updated in place.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/fused_timestep.py (entry points
// `fused_timestep_codebook` and `fused_timestep_dense`, both reaching the
// one `pl.pallas_call` there).  It computes what that kernel computes, not
// its block structure:
//   spikes arrive as uint16 words, 16 spikes each, LSB first;
//   nnz[m]          = popcount of row m, empty[m] = its all-zero words;
//   current[m, n]   = sum over set bits k of w[k, n], with
//                     w[k, n] = cbw[idx[k, n], n] (codebook) or weights[k, n];
//   touch count     = set bits with w[k, n] != 0, or nnz[m] when all_nonzero;
//   LIF             = lazy leak ** (elapsed + 1), threshold, hard reset.
// A row with no spikes does no synaptic work.  The TPU kernel skips per
// (row-tile, column-tile) instead; both give such a row current 0 and touch
// count 0, so the results are the same.
//
// Design (first, simple version).  One block of 128 threads per (row,
// 128-column tile), one thread per column, so the idx (or weight) row of a
// spike is read as 128 consecutive elements.  Warp 0 scans the row's words,
// counts them and compacts the set bits into an ascending list of k in
// shared memory; every thread then walks that list with 8 independent loads
// in flight and adds in ascending k.  The (L, 128) level tile of the
// codebook is staged in shared memory.  The sum is carried in f64 and
// rounded once to f32: with a sequential f32 sum, v' drifted by up to
// 1.1e-4 from the plain version's matmul in the first card run of
// chip_smoke.py's kernel phase (ARCH shapes, input densities up to 1.0);
// with the f64 sum the largest difference is 5.7e-6 (codebook) and 1.7e-5
// (dense), the matmul's own rounding.  Currents still agree with the plain
// version to rounding, not bit for bit; the LIF epilogue uses explicitly
// rounded multiply and add so no FMA contraction adds a second difference.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32) at the paper's widths,
// B = 32: memory.  Layer 1 (2312 -> 4096) moves about 9.5 MB of int8
// indexes plus about 3.1 MB of v / elapsed / spikes / touched traffic,
// about 3.9 us; layer 2 (4096 -> 1024) about 5 MB, about 1.5 us.  This
// design reads the idx row of a spiking k once per batch row that spikes
// there (from L2 after the first), so it moves up to B times the bound's
// index bytes through L2; staging idx rows in shared memory across rows
// (and TMA) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 128;  // columns per block, one per thread
constexpr int kUnroll = 8;    // independent weight loads in flight
constexpr unsigned kFull = 0xffffffffu;

template <bool kCodebook>
struct WeightLoad;

template <>
struct WeightLoad<true> {  // int8 index -> level value staged in shared
  const int8_t* idx;
  const float* levels;     // shared, [n_levels][kBlockN]
  int n, col, tid, max_level;
  __device__ float operator()(int k) const {
    int li = idx[(size_t)k * n + col];
    // the lowering guarantees 0 <= li < n_levels; the clamp only keeps a
    // bad index inside the staged table
    li = min(max(li, 0), max_level);
    return levels[li * kBlockN + tid];
  }
};

template <>
struct WeightLoad<false> {  // dense f32 weights
  const float* w;
  int n, col;
  __device__ float operator()(int k) const { return w[(size_t)k * n + col]; }
};

template <bool kCodebook, bool kPartialUpdate>
__global__ void __launch_bounds__(kBlockN) fused_timestep_kernel(
    const uint16_t* __restrict__ packed,  // (M, Kw)
    const void* __restrict__ weights,     // (16*Kw, N) int8 idx | f32
    const float* __restrict__ cbw,        // (L, N) level values (codebook)
    float* __restrict__ v,                // (M, N) in place
    int* __restrict__ elapsed,            // (M, N) in place
    float* __restrict__ spikes,           // (M, N)
    int* __restrict__ touched,            // (M, N)
    int* __restrict__ nnz_out,            // (M,)
    int* __restrict__ empty_out,          // (M,)
    int kw, int n, int n_levels, float threshold, float leak, float reset,
    int all_nonzero) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* levels = reinterpret_cast<float*>(smem);
  uint16_t* klist = reinterpret_cast<uint16_t*>(
      smem + (kCodebook ? n_levels * kBlockN * sizeof(float) : 0));
  __shared__ int row_nnz;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int col = blockIdx.x * kBlockN + tid;
  const int row = blockIdx.y;
  const bool col_ok = col < n;

  if (kCodebook) {
    for (int l = 0; l < n_levels; ++l)
      levels[l * kBlockN + tid] = col_ok ? cbw[(size_t)l * n + col] : 0.f;
  }
  if (tid < 32) {  // ZSPE scan of the row: count, then compact set bits
    const uint16_t* words = packed + (size_t)row * kw;
    int base = 0, empties = 0;
    for (int w0 = 0; w0 < kw; w0 += 32) {
      const int w = w0 + lane;
      unsigned x = w < kw ? words[w] : 0u;
      const int c = __popc(x);
      empties += (w < kw && x == 0u);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      int off = base + incl - c;
      while (x) {
        klist[off++] = (uint16_t)(w * 16 + __ffs(x) - 1);
        x &= x - 1u;
      }
      base += __shfl_sync(kFull, incl, 31);
    }
    empties = __reduce_add_sync(kFull, empties);
    if (lane == 0) {
      row_nnz = base;
      if (blockIdx.x == 0) {
        nnz_out[row] = base;
        empty_out[row] = empties;
      }
    }
  }
  __syncthreads();
  if (!col_ok) return;

  WeightLoad<kCodebook> load;
  if constexpr (kCodebook) {
    load = {static_cast<const int8_t*>(weights), levels, n, col, tid,
            n_levels - 1};
  } else {
    load = {static_cast<const float*>(weights), n, col};
  }
  const int nnz = row_nnz;
  double acc = 0.0;
  int cnt = 0;
  int j = 0;
  for (; j + kUnroll <= nnz; j += kUnroll) {
    float wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) wv[u] = load(klist[j + u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc += wv[u];
      cnt += wv[u] != 0.f;
    }
  }
  for (; j < nnz; ++j) {
    const float w = load(klist[j]);
    acc += w;
    cnt += w != 0.f;
  }
  if (all_nonzero) cnt = nnz;
  const float cur = (float)acc;

  const size_t o = (size_t)row * n + col;
  const float v0 = v[o];
  float v_new, spk;
  int el_new, tc;
  if (kPartialUpdate) {
    const int pending = elapsed[o] + 1;
    if (cnt > 0) {
      const float decay = powf(leak, (float)pending);
      const float v_int = __fadd_rn(__fmul_rn(v0, decay), cur);
      const bool fire = __fsub_rn(v_int, threshold) >= 0.f;
      spk = fire ? 1.f : 0.f;
      v_new = fire ? reset : v_int;
      el_new = 0;
      tc = 1;
    } else {
      spk = 0.f;
      v_new = v0;
      el_new = pending;
      tc = 0;
    }
  } else {
    const float v_int = __fadd_rn(__fmul_rn(v0, leak), cur);
    const bool fire = __fsub_rn(v_int, threshold) >= 0.f;
    spk = fire ? 1.f : 0.f;
    v_new = fire ? reset : v_int;
    el_new = 0;
    tc = 1;
  }
  v[o] = v_new;
  elapsed[o] = el_new;
  spikes[o] = spk;
  touched[o] = tc;
}

template <bool kCodebook, bool kPartialUpdate>
cudaError_t launch(const void* packed, const void* weights, const void* cbw,
                   void* v, void* elapsed, void* spikes, void* touched,
                   void* nnz, void* empty, int m, int kw, int n, int n_levels,
                   float threshold, float leak, float reset, int all_nonzero,
                   cudaStream_t stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return cudaSuccess;
  if (m > 65535 || kw * 16 > 65536 || (kCodebook && n_levels <= 0))
    return cudaErrorInvalidValue;
  const size_t smem = (kCodebook ? (size_t)n_levels * kBlockN * sizeof(float)
                                 : 0) +
                      (size_t)kw * 16 * sizeof(uint16_t);
  auto kernel = fused_timestep_kernel<kCodebook, kPartialUpdate>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + kBlockN - 1) / kBlockN, m);
  kernel<<<grid, kBlockN, smem, stream>>>(
      static_cast<const uint16_t*>(packed), weights,
      static_cast<const float*>(cbw), static_cast<float*>(v),
      static_cast<int*>(elapsed), static_cast<float*>(spikes),
      static_cast<int*>(touched), static_cast<int*>(nnz),
      static_cast<int*>(empty), kw, n, n_levels, threshold, leak, reset,
      all_nonzero);
  return cudaGetLastError();
}

template <bool kCodebook>
cudaError_t dispatch(const void* packed, const void* weights, const void* cbw,
                     void* v, void* elapsed, void* spikes, void* touched,
                     void* nnz, void* empty, int m, int kw, int n,
                     int n_levels, float threshold, float leak, float reset,
                     int partial_update, int all_nonzero, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (partial_update)
    return launch<kCodebook, true>(packed, weights, cbw, v, elapsed, spikes,
                                   touched, nnz, empty, m, kw, n, n_levels,
                                   threshold, leak, reset, all_nonzero, s);
  return launch<kCodebook, false>(packed, weights, cbw, v, elapsed, spikes,
                                  touched, nnz, empty, m, kw, n, n_levels,
                                  threshold, leak, reset, all_nonzero, s);
}

}  // namespace

extern "C" {

int fused_timestep_codebook_launch(
    const void* packed, const void* idx, const void* cbw, void* v,
    void* elapsed, void* spikes, void* touched, void* nnz, void* empty,
    int m, int kw, int n, int n_levels, float threshold, float leak,
    float reset, int partial_update, int all_nonzero, void* stream) {
  return (int)dispatch<true>(packed, idx, cbw, v, elapsed, spikes, touched,
                             nnz, empty, m, kw, n, n_levels, threshold, leak,
                             reset, partial_update, all_nonzero, stream);
}

int fused_timestep_dense_launch(
    const void* packed, const void* weights, void* v, void* elapsed,
    void* spikes, void* touched, void* nnz, void* empty, int m, int kw,
    int n, float threshold, float leak, float reset, int partial_update,
    int all_nonzero, void* stream) {
  return (int)dispatch<false>(packed, weights, nullptr, v, elapsed, spikes,
                              touched, nnz, empty, m, kw, n, 0, threshold,
                              leak, reset, partial_update, all_nonzero,
                              stream);
}

const char* fused_timestep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
