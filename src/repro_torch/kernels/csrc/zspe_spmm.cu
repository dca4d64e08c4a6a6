// Zero-skip spike matmul (ZSPE + SPE, paper C1) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/zspe_spmm.py
// (entry point `zspe_spmm`, the `pl.pallas_call` there).  It computes what
// that kernel computes, not its block structure:
//   out[m, n]      = sum over k with spikes[m, k] != 0 of spikes[m, k] * w[k, n]
//   skipped[i, j]  = number of the caller's (bm, bk) K-tiles whose spike
//                    tile in row-tile i has no nonzero entry, the same for
//                    every j; tiles that reach past M or K count their
//                    missing part as zero, as the reference counts padding.
// For {0,1} spikes this is the reference's "tile whose popcount is 0"; the
// product skips exactly the work such tiles would add (nothing).
//
// Bound on an H100 SXM (3.35 TB/s): memory.  At the paper's first layer
// (2312 -> 4096) and one step (M = 32, density 0.10) almost every weight
// row is reached by some row of the batch (1 - 0.9^32), so the call must
// read about 38 MB of weights: 11 us.
//
// Design: two launches on the stream, no memset.
// 1. scan: one thread per k and 32-row group loads the group's 32 spikes
//    (all in flight) into a row mask, one bit per row, kept in the
//    wrapper's scratch, so the spikes are read once and not once per
//    column tile; with a flag per 256 k for spikes other than 0 and 1.  It
//    also ORs the caller's (row-tile, K-tile) occupancy bits into a
//    scratch bitmap (one atomic per warp and tile, found by match +
//    ballot).  The gather's first block turns the bitmap into the
//    counters and leaves it zero for the next call on the stream.
// 2. gather: a block of 256 threads owns a (32, 64) output tile over one
//    slice of K; the wrapper's `_plan` picks how many blocks of a
//    thread-block cluster split K, so a one-step call still fills the
//    card.  Per chunk of 1024 k the block reads its row masks, compacts
//    the k that any of its rows reaches into an ascending list, and
//    streams only those weight rows w[k, col0:col0+64] through a four-
//    stage cp.async ring of 32 rows, so each reached weight row leaves L2
//    once per row tile, not once per spiking row.  The adds run on the
//    f64 tensor cores (mma.sync m16n8k16): warp w owns columns 8w .. 8w+7
//    of all 32 rows, b is the staged weight widened to f64 once per block
//    (the f32-to-f64 conversion runs at 16 per SM per clock), and a the
//    spikes: 1 or 0 from the row masks when the chunk's spikes are all 0
//    or 1, else the spike itself.  A row without a spike at k adds
//    0 * w = 0 exactly (an inf or NaN weight gives NaN there, as the
//    reference's dense tile product does).  On the CUDA cores the same
//    adds, one warp-uniform test per (row, k), measured slower at M = 32
//    and M = 640: the per-pair loads and tests, not the f64 operations,
//    set their pace.  The sums are f64, in a fixed order: each block of
//    the cluster adds its share of the tile's f64 partials from
//    distributed shared memory in rank order and rounds once to f32, so
//    two runs are bitwise equal.  Weight rows that are not 16-byte
//    aligned (N % 4 != 0) are staged by 4-byte cp.async.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanK = 256;          // k per scan block, one per thread
constexpr int kChunk = 1024;         // k a gather block lists at once
constexpr int kSegs = kChunk / 32;   // 32-k segments of a chunk
constexpr int kSK = 32;              // weight rows per stage
constexpr int kStages = 4;           // ring: three stages in flight
constexpr int kMaxSplit = 8;         // portable cluster size
constexpr int kMaxK = 32768;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSegs == 32, "one warp scans the segment counts");
static_assert(kSK == 32, "a lane per staged row, a row's bits in a word");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The wrapper's two scratch buffers: `bits`, the caller's occupancy
// bitmap (ceil(M/bm) rows of ceil(ceil(K/bk) / 32) words), zero between
// calls; `masks`, the scan's row masks (ceil(M/32), K) and then its flags
// (ceil(M/32), ceil(K/256)).
__device__ inline int bitmap_words(int k, int bk) {
  return cdiv(cdiv(k, bk), 32);
}

// ---------------------------------------------------------------------------
// 1. scan
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kScanK) zspe_scan_kernel(
    const T* __restrict__ spikes,  // (M, K)
    unsigned* __restrict__ bits, uint32_t* __restrict__ masks, int m, int k,
    int bm, int bk) {
  uint32_t* flags = masks + (size_t)cdiv(m, 32) * k;
  const int wpr = bitmap_words(k, bk);
  const int tid = threadIdx.x, lane = tid & 31;
  const int kk = blockIdx.x * kScanK + tid;
  const int row0 = blockIdx.y * 32;
  const int rows = min(32, m - row0);
  const bool in = kk < k;
  uint32_t mask = 0u;
  bool ones = true;
  if (k > 0) {  // block-uniform
    // rows past M and k past K read a valid neighbour and are masked
    const T* col = spikes + (size_t)row0 * k + min(kk, k - 1);
    float v[32];
#pragma unroll
    for (int r = 0; r < 32; ++r)
      v[r] = (float)col[(size_t)min(r, rows - 1) * k];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      mask |= (uint32_t)((v[r] != 0.f) & (r < rows)) << r;
      ones &= (v[r] == 0.f) | (v[r] == 1.f);
    }
    if (in)
      masks[(size_t)blockIdx.y * k + kk] = mask;
    else
      mask = 0u;
  }
  const int other = __syncthreads_or(!ones);
  if (tid == 0 && k > 0)
    flags[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = other;

  // the caller's occupancy bits: for each caller row tile that meets these
  // 32 rows, the lowest lane of each K-tile among the warp's k that hit it
  const int key = in ? kk / bk : -1;
  const uint32_t same = __match_any_sync(kFull, key);
  for (int i = row0 / bm; i <= (row0 + rows - 1) / bm; ++i) {  // uniform
    const int lo = max(i * bm, row0) - row0;
    const int len = min((i + 1) * bm, row0 + rows) - row0 - lo;
    const uint32_t rm = (len >= 32 ? kFull : (1u << len) - 1u) << lo;
    const bool hit = (mask & rm) != 0u;
    const uint32_t hits = __ballot_sync(kFull, hit) & same;
    if (hit && lane == __ffs(hits) - 1)
      atomicOr(bits + (size_t)i * wpr + key / 32, 1u << (key % 32));
  }
}

// ---------------------------------------------------------------------------
// 2. gather
// ---------------------------------------------------------------------------

// A (kBM, kBN) output tile per block.  Warp w owns columns 8w .. 8w + 7
// of all 32 rows: two 16 x 8 tiles of the f64 tensor-core product
// (mma.sync m16n8k16), stacked along the rows.
constexpr int kBM = 32;                       // a k's row mask is one word
constexpr int kBN = 8 * kWarps;
constexpr int kMTiles = kBM / 16;
constexpr int kLd = kBN + 8;                  // staged row, padded: the
                                              // lanes' B loads hit 32 banks
constexpr int kStage = kSK * kLd;             // floats
constexpr int kRaw = kStages * kStage * 4;    // f32 ring
constexpr int kPartial = kBM * kBN * 8;       // f64 tile, after the loop
constexpr int kRing = kRaw > kPartial ? kRaw : kPartial;
constexpr int kGatherBytes = kRing + kChunk * 4 + kChunk * 2 + kSegs * 8 + 8;

// issue stage `st` of the chunk (list entries st * kSK ..) into `dst`:
// 16-byte cp.async from every thread, or 4-byte ones when rows are not
// 16-byte aligned; zero past the list or N
template <bool kVec>
__device__ __forceinline__ void load_stage(const float* __restrict__ w,
                                           float* dst, const uint16_t* list,
                                           int st, int n_reach, int c0,
                                           int col0, int n) {
  const int base = st * kSK, cnt = min(kSK, n_reach - base);
  constexpr int kE = kVec ? 4 : 1;  // floats per copy
#pragma unroll
  for (int i = 0; i < kSK * kBN / kE / kThreads; ++i) {
    const int e = (i * kThreads + threadIdx.x) * kE;
    const int r = e / kBN, c = e % kBN, col = col0 + c;
    const bool ok = r < cnt && col < n;
    const float* src = ok ? w + (size_t)(c0 + list[base + r]) * n + col : w;
    if constexpr (kVec)
      hopper::cp_async16(dst + r * kLd + c, src, ok ? 16 : 0);
    else
      hopper::cp_async4(dst + r * kLd + c, src, ok ? 4 : 0);
  }
}

// adds one stage: its 32 weight rows in two k-steps of 16.  In k-step s,
// lane (g, t)'s operands take staged rows j = 16s + t + 4v: b[v] is row
// j's weight at the warp's column g, widened to f64 (each staged weight
// once per block), and a, for row tile r, the spikes of rows 16r + g + 8h
// at that k: 1 or 0 from the row mask when all spikes are 0 or 1, else the
// spike itself.  `m_lane` and `k_lane` are lane j's row mask and k.
template <bool kOnes, typename T>
__device__ __forceinline__ void add_stage(
    double (&acc)[kMTiles][4], const float* raw, uint32_t m_lane, int k_lane,
    const T* __restrict__ spikes, int row0, int k, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < kSK / 16; ++s) {
    uint32_t mk[4];
    int kk[4];
    double b[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = 16 * s + t + 4 * v;
      mk[v] = __shfl_sync(kFull, m_lane, j);
      kk[v] = kOnes ? 0 : __shfl_sync(kFull, k_lane, j);
      b[v] = raw[j * kLd + 8 * warp + g];
    }
#pragma unroll
    for (int tile = 0; tile < kMTiles; ++tile) {
      double a[8];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * tile + g + 8 * h;
          const uint32_t bit = (mk[v] >> r) & 1u;
          // 1.0 or 0.0 from the bit's high word: no int-to-f64 conversion
          double x = __hiloint2double((int)(bit * 0x3FF00000u), 0);
          if (!kOnes && bit)
            x = (double)(float)spikes[(size_t)(row0 + r) * k + kk[v]];
          a[2 * v + h] = x;
        }
      hopper::dmma(acc[tile], a, b);
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) zspe_gather_kernel(
    const T* __restrict__ spikes,       // (M, K)
    const float* __restrict__ weights,  // (K, N)
    float* __restrict__ out,            // (M, N)
    int* __restrict__ skipped,          // (ceil(M/bm), ceil(N/bn))
    unsigned* __restrict__ bits, const uint32_t* __restrict__ masks, int m,
    int k, int n, int bm, int bk, int bn, int split, int k_chunk) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* ring = reinterpret_cast<float*>(smem);
  double* partial = reinterpret_cast<double*>(smem);  // after the loop
  uint32_t* kmask = reinterpret_cast<uint32_t*>(smem + kRing);
  uint16_t* klist = reinterpret_cast<uint16_t*>(kmask + kChunk);
  uint32_t* seg_ballot = reinterpret_cast<uint32_t*>(klist + kChunk);
  int* seg_off = reinterpret_cast<int*>(seg_ballot + kSegs);
  int* flag = seg_off + kSegs;  // reached k of the chunk

  const uint32_t* flags = masks + (size_t)cdiv(m, 32) * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = split > 1 ? (int)blockIdx.x % split : 0;
  const int col0 = (blockIdx.x / split) * kBN;
  const int row0 = blockIdx.y * kBM;
  const int k0 = min(k, rank * k_chunk);
  const int k_end = min(k, k0 + k_chunk);
  const int n_flags = cdiv(k, kScanK);
  const uint32_t* gmask = masks + (size_t)blockIdx.y * k;

  // the counters from the scan's bitmap (complete: the scan ran before
  // this launch), which is left zero for the next call on the stream
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    const int gm = cdiv(m, bm), gn = cdiv(n, bn), gk = cdiv(k, bk);
    const int wpr = bitmap_words(k, bk);
    for (int i = tid; i < gm; i += kThreads) {
      int occupied = 0;
      for (int w = 0; w < wpr; ++w) {
        occupied += __popc(bits[(size_t)i * wpr + w]);
        bits[(size_t)i * wpr + w] = 0u;
      }
      for (int j = 0; j < gn; ++j) skipped[(size_t)i * gn + j] = gk - occupied;
    }
  }

  double acc[kMTiles][4];
#pragma unroll
  for (int t = 0; t < kMTiles; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.0;

  for (int c0 = k0; c0 < k_end; c0 += kChunk) {
    const int c_len = min(kChunk, k_end - c0);

    // the chunk's row masks and whether its spikes are all 0 or 1
    int other = 0;
    {
      const int f0 = c0 / kScanK, nf = (c0 + c_len - 1) / kScanK - f0 + 1;
      if (tid < nf) other = flags[(size_t)blockIdx.y * n_flags + f0 + tid];
    }
#pragma unroll
    for (int j = 0; j < kChunk / kThreads; ++j) {
      const int kl = j * kThreads + tid;
      const uint32_t mk = kl < c_len ? gmask[c0 + kl] : 0u;
      kmask[kl] = mk;
      const uint32_t b = __ballot_sync(kFull, mk != 0u);
      if (lane == 0) seg_ballot[j * kWarps + warp] = b;
    }
    const bool ones = !__syncthreads_or(other);

    // the reached k in ascending order
    if (warp == 0) {
      const int c = __popc(seg_ballot[lane]);
      int x = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      seg_off[lane] = x - c;
      if (lane == 31) flag[0] = x;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk / kThreads; ++j) {
      const int kl = j * kThreads + tid, seg = j * kWarps + warp;
      if ((seg_ballot[seg] >> lane) & 1u)
        klist[seg_off[seg] +
              __popc(seg_ballot[seg] & ((1u << lane) - 1u))] = (uint16_t)kl;
    }
    const int n_reach = flag[0];
    __syncthreads();

    // stream the reached weight rows and add
    const int n_st = cdiv(n_reach, kSK);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_st)
        load_stage<kVec>(weights, ring + s * kStage, klist, s, n_reach, c0,
                         col0, n);
      hopper::cp_async_commit();
    }
    for (int st = 0; st < n_st; ++st) {
      // lane j: the row mask and k of the stage's j-th weight row
      const int j = st * kSK + lane;
      const int kl = j < n_reach ? klist[j] : 0;
      const uint32_t m_lane = j < n_reach ? kmask[kl] : 0u;
      hopper::cp_async_wait<kStages - 2>();  // stage st has landed
      __syncthreads();  // ... for every thread; stage st - 1 was added
      {
        const int nxt = st + kStages - 1;
        if (nxt < n_st)
          load_stage<kVec>(weights, ring + (nxt % kStages) * kStage, klist,
                           nxt, n_reach, c0, col0, n);
        hopper::cp_async_commit();
      }
      const float* raw = ring + (st % kStages) * kStage;
      if (ones)
        add_stage<true, T>(acc, raw, m_lane, c0 + kl, spikes, row0, k, warp,
                           lane);
      else
        add_stage<false, T>(acc, raw, m_lane, c0 + kl, spikes, row0, k, warp,
                            lane);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();  // the chunk's shared arrays are free again
  }

  // lane (g, t) holds rows 16 r + g + 8 h, columns 8 w + 2 t + i
  const int g = lane >> 2, cq = 8 * warp + 2 * (lane & 3);
  if (split == 1) {
#pragma unroll
    for (int t = 0; t < kMTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 16 * t + g + 8 * (e >> 1);
        const int col = col0 + cq + (e & 1);
        if (row < m && col < n) out[(size_t)row * n + col] = (float)acc[t][e];
      }
    return;
  }
  // the cluster's partial tiles through distributed shared memory: rank r
  // adds its share of the tile's elements over all ranks, in rank order,
  // and writes them
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int t = 0; t < kMTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      partial[(16 * t + g + 8 * (e >> 1)) * kBN + cq + (e & 1)] = acc[t][e];
  cluster.sync();
  const int share = kBM * kBN / split;
  for (int e = rank * share + tid; e < (rank + 1) * share; e += kThreads) {
    double sum = cluster.map_shared_rank(partial, 0)[e];
    for (int o = 1; o < split; ++o)
      sum += cluster.map_shared_rank(partial, o)[e];
    const int row = row0 + e / kBN, col = col0 + e % kBN;
    if (row < m && col < n) out[(size_t)row * n + col] = (float)sum;
  }
  cluster.sync();  // the others' shared memory stays until it is read
}

template <typename T, bool kVec>
cudaError_t gather(const void* spikes, const void* weights, void* out,
                   void* skipped, void* bits, const void* masks, int m, int k,
                   int n, int bm, int bk, int bn, int split, int k_chunk,
                   cudaStream_t stream) {
  auto kernel = zspe_gather_kernel<T, kVec>;
  // above 48 KB a kernel must opt in; the attribute is per device, so it
  // is set on every launch (a host call allowed during graph capture)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGatherBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(n, kBN) * split, cdiv(m, kBM));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kGatherBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(spikes),
      static_cast<const float*>(weights), static_cast<float*>(out),
      static_cast<int*>(skipped), static_cast<unsigned*>(bits),
      static_cast<const uint32_t*>(masks), m, k, n, bm, bk, bn, split,
      k_chunk);
}

template <typename T>
cudaError_t run(const void* spikes, const void* weights, void* out,
                void* skipped, void* bits, void* masks, int m, int k, int n,
                int bm, int bk, int bn, int split, int k_chunk,
                cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (k < 0 || k > kMaxK || bm <= 0 || bk <= 0 || bn <= 0 || split < 1 ||
      split > kMaxSplit || k_chunk <= 0 || k_chunk % 32 ||
      (long long)split * k_chunk < k || cdiv(m, 32) > 65535)
    return cudaErrorInvalidValue;
  zspe_scan_kernel<T><<<dim3(cdiv(k, kScanK) > 0 ? cdiv(k, kScanK) : 1,
                             cdiv(m, 32)),
                        kScanK, 0, stream>>>(
      static_cast<const T*>(spikes), static_cast<unsigned*>(bits),
      static_cast<uint32_t*>(masks), m, k, bm, bk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 16-byte copies need 16-byte aligned rows and base
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(weights) % 16 == 0)
    return gather<T, true>(spikes, weights, out, skipped, bits, masks, m, k,
                           n, bm, bk, bn, split, k_chunk, stream);
  return gather<T, false>(spikes, weights, out, skipped, bits, masks, m, k, n,
                          bm, bk, bn, split, k_chunk, stream);
}

}  // namespace

extern "C" {

// Words of the two scratch buffers a call needs: `bits` (zero between
// calls) and `masks`.
long long zspe_spmm_bits_words(int m, int k, int bm, int bk) {
  return (long long)cdiv(m, bm) * cdiv(cdiv(k, bk), 32);
}
long long zspe_spmm_masks_words(int m, int k) {
  return (long long)cdiv(m, 32) * (k + cdiv(k, kScanK));
}

// spikes (M, K) f32 or int8 (spikes_int8 = 1); weights (K, N) f32; out
// (M, N) f32; skipped (ceil(M/bm), ceil(N/bn)) int32 for the caller's block
// (bm, bk, bn); bits: zspe_spmm_bits_words(...) words, zero, and left
// zero; masks: zspe_spmm_masks_words(...) words.  The plan: a cluster of
// `split` blocks (1..8) along K, each over k_chunk rows of K (a multiple
// of 32, split * k_chunk >= K).
int zspe_spmm_launch(const void* spikes, int spikes_int8, const void* weights,
                     void* out, void* skipped, void* bits, void* masks, int m,
                     int k, int n, int bm, int bk, int bn, int split,
                     int k_chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (spikes_int8)
    return (int)run<int8_t>(spikes, weights, out, skipped, bits, masks, m, k,
                            n, bm, bk, bn, split, k_chunk, s);
  return (int)run<float>(spikes, weights, out, skipped, bits, masks, m, k, n,
                         bm, bk, bn, split, k_chunk, s);
}

const char* zspe_spmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
