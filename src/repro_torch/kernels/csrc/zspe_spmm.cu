// Zero-skip spike matmul (ZSPE + SPE, paper C1) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/zspe_spmm.py
// (entry point `zspe_spmm`, the `pl.pallas_call` there).  It computes what
// that kernel computes, not its block structure:
//   out[m, n]      = sum over k with spikes[m, k] != 0 of spikes[m, k] * w[k, n]
//   skipped[i, j]  = number of K-tiles kk whose (bm, bk) spike tile in
//                    row-tile i has no nonzero entry, the same for every j;
//                    tiles that reach past M or K count their missing part
//                    as zero, exactly as the reference counts zero padding.
// For {0,1} spikes this is the reference's "tile whose popcount is 0"; the
// product skips exactly the work such tiles would add (nothing).
//
// Design (first, simple version), two kernels on the stream:
// 1. scan: one warp per row walks the row 32 spikes at a time, compacts the
//    nonzero k into an ascending list (ballot + popcount, as the chip's ZSPE
//    forwards only valid spikes) and flags each (row-tile, K-tile) it finds
//    occupied (one store per row and tile; the flags are zeroed first).
//    At B = 32 only 32 warps scan, so each loads 8 chunks before its first
//    ballot: with one load in flight the scan took 39 us per call at the
//    paper's first layer (chip_smoke.py phase 5, H100).
// 2. gather: one block of 128 threads per (row, 128-column tile), one
//    thread per column.  The row's list and spike values are staged in
//    shared memory; every thread walks the list with 8 independent weight
//    loads in flight and adds in ascending k, in f64, rounding once to f32
//    (as fused_timestep.cu does: an f32 running sum drifted 1.1e-4 from a
//    matmul at the paper's widths).  The first block of each row-tile
//    counts the tile's empty K-tiles from the flags and writes the counters.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32) at the paper's widths
// with M = 640 (B = 32 x T = 20): memory.  Layer 1 (2312 -> 4096) must read
// every weight row some spike reaches (about 38 MB) plus 5.9 MB of spikes
// and write 10.5 MB, about 16 us.  This design reads the weight row of a
// spike once per batch row that spikes there (from L2 after the first), so
// it moves nnz * N * 4 bytes through L2; sharing weight rows across the
// rows of a tile is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanWarps = 4;     // rows per scan block, one warp each
constexpr int kScanAhead = 8;     // 32-spike chunks a warp loads at once
constexpr int kBlockN = 128;      // columns per gather block, one per thread
constexpr int kUnroll = 8;        // independent weight loads in flight
constexpr int kMaxK = 32768;      // a row's (k, value) list fits in shared
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kScanWarps * 32) zspe_scan_kernel(
    const T* __restrict__ spikes,   // (M, K)
    uint16_t* __restrict__ klist,   // (M, K) scratch: ascending nonzero k
    int* __restrict__ nnz_out,      // (M,) list lengths
    int* __restrict__ occupied,     // (M/bm, n_ktiles) flags, zeroed
    int m, int k, int bm, int bk, int n_ktiles) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // the whole warp leaves together
  const T* s = spikes + (size_t)row * k;
  uint16_t* list = klist + (size_t)row * k;
  int* occ = occupied + (size_t)(row / bm) * n_ktiles;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
  int last_tile = -1;  // warp-uniform: tile of the highest k listed so far
  for (int k1 = 0; k1 < k; k1 += 32 * kScanAhead) {
    bool nzs[kScanAhead];  // loads in flight before the first ballot
#pragma unroll
    for (int c = 0; c < kScanAhead; ++c) {
      const int kk = k1 + c * 32 + lane;
      nzs[c] = kk < k && s[kk] != (T)0;
    }
#pragma unroll
    for (int c = 0; c < kScanAhead; ++c) {
      const int k0 = k1 + c * 32;
      const int kk = k0 + lane;
      const unsigned mask = __ballot_sync(kFull, nzs[c]);
      if (nzs[c]) {
        const unsigned lower = mask & below;
        list[base + __popc(lower)] = (uint16_t)kk;
        // k ascends with the lane, so the first nonzero of a tile is the
        // one whose next lower nonzero lies in an earlier tile
        const int tile = kk / bk;
        const bool first =
            lower == 0u || (k0 + 31 - __clz(lower)) / bk != tile;
        if (first && tile != last_tile) occ[tile] = 1;
      }
      if (mask) last_tile = (k0 + 31 - __clz(mask)) / bk;
      base += __popc(mask);
    }
  }
  if (lane == 0) nnz_out[row] = base;
}

template <typename T>
__global__ void __launch_bounds__(kBlockN) zspe_gather_kernel(
    const T* __restrict__ spikes,       // (M, K)
    const float* __restrict__ weights,  // (K, N)
    const uint16_t* __restrict__ klist, const int* __restrict__ nnz_in,
    const int* __restrict__ occupied, float* __restrict__ out,
    int* __restrict__ skipped,          // (M/bm, n_coltiles)
    int k, int n, int bm, int n_ktiles, int n_coltiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* vals = reinterpret_cast<float*>(smem);
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem + (size_t)k * sizeof(float));

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int col = blockIdx.x * kBlockN + tid;
  const int nnz = nnz_in[row];
  const size_t roff = (size_t)row * k;
  for (int j = tid; j < nnz; j += kBlockN) {
    const int kk = klist[roff + j];
    ks[j] = (uint16_t)kk;
    vals[j] = (float)spikes[roff + kk];
  }
  if (blockIdx.x == 0 && row % bm == 0) {  // block-uniform branch
    const int tile_row = row / bm;
    const int* occ = occupied + (size_t)tile_row * n_ktiles;
    int empties = 0;
    for (int t0 = 0; t0 < n_ktiles; t0 += kBlockN) {
      const int t = t0 + tid;
      empties += __syncthreads_count(t < n_ktiles && occ[t] == 0);
    }
    for (int j = tid; j < n_coltiles; j += kBlockN)
      skipped[(size_t)tile_row * n_coltiles + j] = empties;
  }
  __syncthreads();
  if (col >= n) return;

  double acc = 0.0;
  int j = 0;
  for (; j + kUnroll <= nnz; j += kUnroll) {
    float wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      wv[u] = weights[(size_t)ks[j + u] * n + col];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc += (double)wv[u] * (double)vals[j + u];
  }
  for (; j < nnz; ++j)
    acc += (double)weights[(size_t)ks[j] * n + col] * (double)vals[j];
  out[(size_t)row * n + col] = (float)acc;
}

template <typename T>
cudaError_t run(const void* spikes, const void* weights, void* out,
                void* skipped, void* klist, void* nnz, void* occupied, int m,
                int k, int n, int bm, int bk, int bn, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k < 0 || k > kMaxK || m > 65535 || bm <= 0 || bk <= 0 || bn <= 0)
    return cudaErrorInvalidValue;
  const int n_ktiles = (k + bk - 1) / bk;
  const int n_rowtiles = (m + bm - 1) / bm;
  const int n_coltiles = (n + bn - 1) / bn;
  cudaError_t err;
  if (n_ktiles > 0) {
    err = cudaMemsetAsync(occupied, 0,
                          (size_t)n_rowtiles * n_ktiles * sizeof(int), stream);
    if (err != cudaSuccess) return err;
  }
  zspe_scan_kernel<T><<<(m + kScanWarps - 1) / kScanWarps, kScanWarps * 32, 0,
                        stream>>>(
      static_cast<const T*>(spikes), static_cast<uint16_t*>(klist),
      static_cast<int*>(nnz), static_cast<int*>(occupied), m, k, bm, bk,
      n_ktiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)k * (sizeof(float) + sizeof(uint16_t));
  auto gather = zspe_gather_kernel<T>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        gather, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + kBlockN - 1) / kBlockN, m);
  gather<<<grid, kBlockN, smem, stream>>>(
      static_cast<const T*>(spikes), static_cast<const float*>(weights),
      static_cast<const uint16_t*>(klist), static_cast<const int*>(nnz),
      static_cast<const int*>(occupied), static_cast<float*>(out),
      static_cast<int*>(skipped), k, n, bm, n_ktiles, n_coltiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// spikes (M, K) f32 or int8 (spikes_int8 = 1); weights (K, N) f32; out
// (M, N) f32; skipped (ceil(M/bm), ceil(N/bn)) int32; scratch: klist (M, K)
// 16-bit, nnz (M,) int32, occupied (ceil(M/bm), ceil(K/bk)) int32.
int zspe_spmm_launch(const void* spikes, int spikes_int8, const void* weights,
                     void* out, void* skipped, void* klist, void* nnz,
                     void* occupied, int m, int k, int n, int bm, int bk,
                     int bn, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (spikes_int8)
    return (int)run<int8_t>(spikes, weights, out, skipped, klist, nnz,
                            occupied, m, k, n, bm, bk, bn, s);
  return (int)run<float>(spikes, weights, out, skipped, klist, nnz, occupied,
                         m, k, n, bm, bk, bn, s);
}

const char* zspe_spmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
