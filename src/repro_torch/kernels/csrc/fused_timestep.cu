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
//                     w[k, n] = cbw[idx[k, n], n] for 0 <= idx < L and 0
//                     for any other index (codebook; the reference's
//                     compare-and-select dequant), or weights[k, n];
//   touch count     = set bits with w[k, n] != 0, or nnz[m] when all_nonzero;
//   LIF             = lazy leak ** (elapsed + 1), threshold, hard reset.
// A row with no spikes does no synaptic work.  The TPU kernel skips per
// (row-tile, column-tile) instead; both give such a row current 0 and touch
// count 0, so the results are the same.  Sums are carried in f64 and
// rounded once to f32 (a sequential f32 sum drifted by up to 1.1e-4 from
// the plain version's matmul at the paper's widths); the LIF epilogue uses
// explicitly rounded multiply and add so no FMA contraction adds a second
// difference.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32) at the paper's widths,
// B = 32, density 0.10: memory.  Layer 1 (2312 -> 4096) must read the
// index rows some spike reaches (1 - 0.9^32 of them, about 9.2 MB) plus
// about 3.1 MB of v / elapsed / spikes / touched traffic, about 3.7 us;
// layer 2 (4096 -> 1024) about 5 MB, about 1.5 us.
//
// Codebook kernel.  A block owns a (32, BN) output tile over all of K: BN =
// 16 with 256 threads, or, where 16 would leave the grid short of one block
// per SM (the wrapper's `_plan` decides and the kernel trusts it), BN = 8
// with 512 threads.  It stages the tile's level table once, as f64, with a
// zero level that every index outside [0, L) selects (int8 reaches only
// levels 0..127, so at most 128 levels are staged).  Per chunk of 256 spike
// words it reads the 32 rows' words (each thread's loads in flight at
// once); a warp per pair of word columns turns lane r's 32 bits (row r)
// into lane j's 32-row mask of k = 32 p + j by five butterfly swaps and
// ballots which of those k any row reaches; the reached k are compacted
// into an ascending list.  Only those index rows idx[k, col0:col0+BN] are
// streamed, by cp.async with their row masks beside them, through an
// eight-stage ring of one row per thread, so each reached index row leaves
// L2 once per 32-row tile, not once per spiking row.  The adds run on the
// f64 tensor cores (mma.sync m16n8k16): warp w takes k-steps w and w + warps
// of each stage; A is 1 or 0 from the row masks, B the level each index
// selects, looked up in the staged table.  The touched mask of a column is
// the OR of the row masks of the k whose level is not +-0, so the touch
// flags need no second product.  The warps' f64 partial tiles are added in
// warp order and rounded once to f32, so two runs are bitwise equal.  One
// launch per call, no memset, no scratch.  At M = 32 and density 0.10 the
// dense 32-row product does ten times the adds the spiking (row, k) pairs
// need; on the tensor cores that still cost less than walking only the
// pairs on the CUDA cores, whose per-pair level lookups set the pace, and
// a split of the words over a thread-block cluster lost to one block per
// tile (cluster placement left SMs with two blocks beside idle ones).
//
// Dense kernel (float simulators).  One block of 128 threads per (row,
// 128-column tile), one thread per column, so the weight row of a spike is
// read as 128 consecutive floats.  Warp 0 scans the row's words, counts them
// and compacts the set bits into an ascending list of k in shared memory;
// every thread then walks that list with 8 independent loads in flight.  It
// reads the weight row of a spiking k once per batch row that spikes there
// (from L2 after the first).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The neuron-updater stage for element o, whose v and elapsed are v0 and
// el0 (el0 is not read under full update): `hit` is touch count > 0.
template <bool kPartialUpdate>
__device__ __forceinline__ void lif_store(size_t o, float v0, int el0,
                                          float cur, bool hit, float* v,
                                          int* elapsed, float* spikes,
                                          int* touched, float threshold,
                                          float leak, float reset) {
  float v_new, spk;
  int el_new, tc;
  if (kPartialUpdate) {
    const int pending = el0 + 1;
    if (hit) {
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

// ---------------------------------------------------------------------------
// dense kernel
// ---------------------------------------------------------------------------

constexpr int kDenseN = 128;  // columns per block, one per thread
constexpr int kUnroll = 8;    // independent weight loads in flight

template <bool kPartialUpdate>
__global__ void __launch_bounds__(kDenseN) fused_timestep_dense_kernel(
    const uint16_t* __restrict__ packed,  // (M, Kw)
    const float* __restrict__ weights,    // (16*Kw, N)
    float* __restrict__ v,                // (M, N) in place
    int* __restrict__ elapsed,            // (M, N) in place
    float* __restrict__ spikes,           // (M, N)
    int* __restrict__ touched,            // (M, N)
    int* __restrict__ nnz_out,            // (M,)
    int* __restrict__ empty_out,          // (M,)
    int kw, int n, float threshold, float leak, float reset,
    int all_nonzero) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint16_t* klist = reinterpret_cast<uint16_t*>(smem);
  __shared__ int row_nnz;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int col = blockIdx.x * kDenseN + tid;
  const int row = blockIdx.y;
  const bool col_ok = col < n;

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

  const float* w = weights + col;
  const int nnz = row_nnz;
  double acc = 0.0;
  int cnt = 0;
  int j = 0;
  for (; j + kUnroll <= nnz; j += kUnroll) {
    float wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) wv[u] = w[(size_t)klist[j + u] * n];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc += wv[u];
      cnt += wv[u] != 0.f;
    }
  }
  for (; j < nnz; ++j) {
    const float wk = w[(size_t)klist[j] * n];
    acc += wk;
    cnt += wk != 0.f;
  }
  if (all_nonzero) cnt = nnz;
  const size_t o = (size_t)row * n + col;
  lif_store<kPartialUpdate>(o, v[o], kPartialUpdate ? elapsed[o] : 0,
                            (float)acc, cnt > 0, v, elapsed, spikes, touched,
                            threshold, leak, reset);
}

// ---------------------------------------------------------------------------
// codebook kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 32;                    // a k's row mask is one word
constexpr int kMTiles = kBM / 16;          // m16 tiles of the f64 product
constexpr int kChunkWords = 256;           // spike words listed at once
constexpr int kChunk = kChunkWords * 16;   // their k
constexpr int kWordsLd = kChunkWords + 2;  // a row of staged words, padded:
                                           // lane = row hits 32 banks
constexpr int kSegs = kChunk / 32;         // 32-k segments of a chunk
constexpr int kLd = 16;                    // a staged index row (BN <= 16
                                           // bytes): the four rows of a B
                                           // load start in four banks
constexpr int kStages = 8;                 // ring: seven stages in flight
constexpr int kBatch = 8;                  // global loads a thread has in
                                           // flight while staging
constexpr int kMaxLevels = 128;            // int8 reaches levels 0..127
constexpr int kSmemMax = 232448;           // an H100 block's shared memory
static_assert(kSegs == 4 * 32, "a lane of warp 0 scans four segments");

// A block of a tile one n8 tile wide has 512 threads, two n8 tiles wide 256:
// a stage holds an index row per thread, two k-steps of 16 for each warp.
__host__ __device__ constexpr int block_threads(int bn) {
  return bn == 8 ? 512 : 256;
}
template <int kNT>
struct Shape {
  static constexpr int kThreads = block_threads(8 * kNT);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSK = kThreads;  // index rows per stage
  static constexpr int kMinBlocks = 65536 / (kThreads * 128);  // on an SM,
                                                 // at 128 registers a thread
  static_assert(kSK / 16 == 2 * kWarps, "two k-steps of a stage per warp");
};

// Bytes of the block's shared memory: the level table and the ring of index
// rows and their row masks, which the warps' f64 partial tiles and touched
// masks reuse after the loop; then the staged spike words, the chunk's row
// masks and k-list, the segment counts and the per-row spike and empty-word
// counts.
// `fused_timestep.py` `_smem_bytes` computes the same.
__host__ __device__ constexpr int region_bytes(int bn, int ls) {
  return (ls + 1) * bn * 8 + kStages * block_threads(bn) * (kLd + 4) >
                 block_threads(bn) / 32 * (kBM * bn * 8 + bn * 4)
             ? (ls + 1) * bn * 8 + kStages * block_threads(bn) * (kLd + 4)
             : block_threads(bn) / 32 * (kBM * bn * 8 + bn * 4);
}
constexpr int kFixedBytes = kBM * kWordsLd * 2 + kChunk * 4 + kChunk * 2 +
                            kSegs * 4 * 2 + 2 * kBM * 4 + 16;
__host__ __device__ constexpr int smem_bytes(int bn, int n_levels) {
  return region_bytes(bn, n_levels < kMaxLevels ? n_levels : kMaxLevels) +
         kFixedBytes;
}

// start stage `st` of the chunk (list entries st * kSK ..) into `dst`, a
// row per thread: a cp.async of the tile's kBN bytes, or, when index rows
// are not kBN-byte aligned, byte loads of its columns before N; and the
// row's mask into `dmask`.  A row past the list gets mask 0 and index
// bytes 0xff, which select the zero level.
template <int kNT, bool kVec>
__device__ __forceinline__ void load_stage(const int8_t* __restrict__ idx,
                                           uint8_t* dst, uint32_t* dmask,
                                           const uint16_t* list,
                                           const uint32_t* kmask, int st,
                                           int n_reach, int k0, int col0,
                                           int n) {
  constexpr int kBN = 8 * kNT, kSK = Shape<kNT>::kSK;
  const int r = threadIdx.x, j = st * kSK + r;
  if (j >= n_reach) {
    *reinterpret_cast<uint4*>(dst + r * kLd) = make_uint4(~0u, ~0u, ~0u, ~0u);
    dmask[r] = 0u;
    return;
  }
  const int kl = list[j];
  dmask[r] = kmask[kl];
  const int8_t* src = idx + (size_t)(k0 + kl) * n + col0;
  if constexpr (kVec) {
    if constexpr (kBN == 16)
      hopper::cp_async16(dst + r * kLd, src, 16);
    else
      hopper::cp_async8(dst + r * kLd, src, 8);
  } else {  // its columns before N, the loads in flight together
    uint8_t x[kBN];
#pragma unroll
    for (int c = 0; c < kBN; ++c)
      x[c] = col0 + c < n ? (uint8_t)src[c] : (uint8_t)0;
#pragma unroll
    for (int c = 0; c < kBN; ++c) dst[r * kLd + c] = x[c];
  }
}

// the level table, f64, [column][level], with a zero level ls
template <int kNT>
__device__ __forceinline__ void stage_table(double* table,
                                            const float* __restrict__ cbw,
                                            int ls, int col0, int n) {
  constexpr int kBN = 8 * kNT, kThreads = Shape<kNT>::kThreads;
  for (int e0 = 0; e0 < (ls + 1) * kBN; e0 += kBatch * kThreads) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      const int l = e / kBN, col = col0 + e % kBN;
      x[u] = l < ls && col < n ? cbw[(size_t)l * n + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < (ls + 1) * kBN)
        table[e % kBN * (ls + 1) + e / kBN] = (double)x[u];
    }
  }
}

// adds the warp's two k-steps of a stage (s = warp, warp + kWarps): the
// product of the 32 rows' 0/1 spikes at the k-step's 16 k with the levels
// their indexes select.  Lane (g, t)'s operands take stage rows
// j = 16 s + t + 4 v: b, for each n8 tile, is the level of j's index at the
// tile's column g (index bytes past ls, which every negative int8 is as
// unsigned, select the zero level), and a, for m16 tile i, is 1 or 0 as
// row 16 i + g + 8 h's bit in j's mask is set.  The touched mask of the
// column ORs j's row mask where the level is not +-0.  A warp whose first
// k-step lies past the list (`rows` rows of the stage are listed) adds
// nothing; its second may, and then adds the padding rows' zeros, so both
// k-steps' loads are in flight together.
template <int kNT>
__device__ __forceinline__ void add_stage(
    double (&acc)[kNT][kMTiles][4], uint32_t (&tmask)[kNT],
    const uint8_t* raw, const uint32_t* smask, const double* table, int rows,
    uint32_t ls, int warp, int lane) {
  constexpr int kWarps = Shape<kNT>::kWarps;
  if (16 * warp >= rows) return;
  const int g = lane >> 2, t = lane & 3;
  const int lp = (int)ls + 1;
  const double* my_table = table + g * lp;
  const uint8_t* my_raw = raw + g;
  uint32_t m4[2][4];
  double b[2][kNT][4];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = 16 * (warp + kWarps * h2) + t + 4 * v;
      m4[h2][v] = smask[j];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint32_t ix = my_raw[j * kLd + 8 * nt];
        b[h2][nt][v] = my_table[8 * nt * lp + min(ix, ls)];
        if (__double2hiint(b[h2][nt][v]) & 0x7fffffff)
          tmask[nt] |= m4[h2][v];
      }
    }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      double a[8];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          // 1.0 or 0.0 by its high word: no int-to-f64 conversion
          a[2 * v + h] = __hiloint2double(
              m4[h2][v] & 1u << (16 * i + g + 8 * h) ? 0x3FF00000 : 0, 0);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        hopper::dmma(acc[nt][i], a, b[h2][nt]);
    }
}

template <int kNT, bool kVec, bool kPartialUpdate>
__global__ void __launch_bounds__(Shape<kNT>::kThreads, Shape<kNT>::kMinBlocks)
    fused_timestep_codebook_kernel(
    const uint16_t* __restrict__ packed,  // (M, Kw)
    const int8_t* __restrict__ idx,       // (16*Kw, N)
    const float* __restrict__ cbw,        // (L, N)
    float* __restrict__ v,                // (M, N) in place
    int* __restrict__ elapsed,            // (M, N) in place
    float* __restrict__ spikes,           // (M, N)
    int* __restrict__ touched,            // (M, N)
    int* __restrict__ nnz_out,            // (M,)
    int* __restrict__ empty_out,          // (M,)
    int m, int kw, int n, int n_levels, float threshold, float leak,
    float reset, int all_nonzero) {
  constexpr int kBN = 8 * kNT;
  constexpr int kThreads = Shape<kNT>::kThreads, kWarps = Shape<kNT>::kWarps;
  constexpr int kSK = Shape<kNT>::kSK;
  constexpr int kStage = kSK * kLd;  // bytes
  extern __shared__ __align__(128) uint8_t smem[];
  const int ls = min(n_levels, kMaxLevels);
  double* table = reinterpret_cast<double*>(smem);
  uint8_t* ring = smem + (ls + 1) * kBN * 8;
  uint32_t* ring_mask = reinterpret_cast<uint32_t*>(ring + kStages * kStage);
  double* partial = reinterpret_cast<double*>(smem);  // after the loop
  uint32_t* pmask =
      reinterpret_cast<uint32_t*>(smem + kWarps * kBM * kBN * 8);
  uint16_t* words = reinterpret_cast<uint16_t*>(smem + region_bytes(kBN, ls));
  uint32_t* kmask = reinterpret_cast<uint32_t*>(words + kBM * kWordsLd);
  uint16_t* klist = reinterpret_cast<uint16_t*>(kmask + kChunk);
  uint32_t* seg_ballot = reinterpret_cast<uint32_t*>(klist + kChunk);
  int* seg_off = reinterpret_cast<int*>(seg_ballot + kSegs);
  int* row_cnt = seg_off + kSegs;  // spikes, then empty words, per row
  int* n_reach_s = row_cnt + 2 * kBM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;

  if (tid < 2 * kBM) row_cnt[tid] = 0;
  double acc[kNT][kMTiles][4];
  uint32_t tmask[kNT];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    tmask[nt] = 0u;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][i][e] = 0.0;
  }
  int row_nnz = 0, row_empty = 0;  // lane's row, this warp's word columns

  for (int c0w = 0; c0w < kw; c0w += kChunkWords) {
    const int nw = min(kChunkWords, kw - c0w);
    const int k0 = c0w * 16;

    // the chunk's spike words of the 32 rows: warp w reads rows w + kWarps i
    // along the row, all of a thread's loads in flight at once
    {
      constexpr int kRows = kBM / kWarps, kCols = kChunkWords / 32;
      uint16_t x[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int row = row0 + warp + kWarps * i, wc = lane + 32 * c;
          x[i][c] = wc < nw && row < m
                        ? packed[(size_t)row * kw + c0w + wc]
                        : (uint16_t)0;
        }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (lane + 32 * c < nw)
            words[(warp + kWarps * i) * kWordsLd + lane + 32 * c] = x[i][c];
    }
    __syncthreads();

    // one row mask per k: a warp per pair of word columns (32 k) moves
    // lane r's 32 bits (row r) to lane j's bit r (k = 32 p + j) by five
    // butterfly swaps, and ballots which of the 32 k any row reaches
    for (int p = warp; 2 * p < nw; p += kWarps) {
      uint32_t x = *reinterpret_cast<const uint32_t*>(
          words + lane * kWordsLd + 2 * p);
      if (2 * p + 1 == nw) x &= 0xffffu;  // the word past the chunk
      row_nnz += __popc(x);
      if (row0 + lane < m)
        row_empty += ((x & 0xffffu) == 0u) + (2 * p + 1 < nw && x < 0x10000u);
#pragma unroll
      for (int j = 16; j >= 1; j >>= 1) {
        const uint32_t lo = j == 16 ? 0x0000ffffu
                            : j == 8 ? 0x00ff00ffu
                            : j == 4 ? 0x0f0f0f0fu
                            : j == 2 ? 0x33333333u
                                     : 0x55555555u;
        const uint32_t y = __shfl_xor_sync(kFull, x, j);
        x = lane & j ? (x & ~lo) | ((y & ~lo) >> j)
                     : (x & lo) | ((y & lo) << j);
      }
      kmask[32 * p + lane] = x;
      const uint32_t b = __ballot_sync(kFull, x != 0u);
      if (lane == 0) seg_ballot[p] = b;
    }
    if (tid < kSegs && 2 * tid >= nw) seg_ballot[tid] = 0u;
    __syncthreads();

    // the reached k in ascending order
    if (warp == 0) {
      int c[4], x = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) x += c[i] = __popc(seg_ballot[4 * lane + i]);
      const int mine = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      int off = x - mine;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        seg_off[4 * lane + i] = off;
        off += c[i];
      }
      if (lane == 31) n_reach_s[0] = x;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunk / kThreads; ++j) {
      const int kl = j * kThreads + tid, seg = j * kWarps + warp;
      if ((seg_ballot[seg] >> lane) & 1u)
        klist[seg_off[seg] +
              __popc(seg_ballot[seg] & ((1u << lane) - 1u))] = (uint16_t)kl;
    }
    const int n_reach = n_reach_s[0];
    __syncthreads();

    // stream the reached index rows and add; the level table is staged
    // once, while the first stages are in flight
    const int n_st = cdiv(n_reach, kSK);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_st)
        load_stage<kNT, kVec>(idx, ring + s * kStage, ring_mask + s * kSK,
                              klist, kmask, s, n_reach, k0, col0, n);
      hopper::cp_async_commit();
    }
    if (c0w == 0) stage_table<kNT>(table, cbw, ls, col0, n);
    for (int st = 0; st < n_st; ++st) {
      hopper::cp_async_wait<kStages - 2>();  // stage st has landed
      __syncthreads();  // ... for every thread; stage st - 1 was added
      {
        const int nxt = st + kStages - 1;
        if (nxt < n_st)
          load_stage<kNT, kVec>(idx, ring + (nxt % kStages) * kStage,
                                ring_mask + (nxt % kStages) * kSK, klist,
                                kmask, nxt, n_reach, k0, col0, n);
        hopper::cp_async_commit();
      }
      add_stage<kNT>(acc, tmask, ring + (st % kStages) * kStage,
                     ring_mask + (st % kStages) * kSK, table,
                     n_reach - st * kSK, (uint32_t)ls, warp, lane);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();  // the chunk's shared arrays are free again
  }

  // the warps' partial tiles and touched masks, and the per-row counts;
  // lane (g, t) holds rows 16 i + g + 8 h, columns 8 nt + 2 t + c
  atomicAdd(&row_cnt[lane], row_nnz);
  atomicAdd(&row_cnt[kBM + lane], row_empty);
  {
    const int g = lane >> 2, t = lane & 3;
    double* mine = partial + warp * kBM * kBN;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(16 * i + g + 8 * (e >> 1)) * kBN + 8 * nt + 2 * t + (e & 1)] =
              acc[nt][i][e];
      uint32_t tm = tmask[nt];
      tm |= __shfl_xor_sync(kFull, tm, 1);
      tm |= __shfl_xor_sync(kFull, tm, 2);
      if (t == 0) pmask[warp * kBN + 8 * nt + g] = tm;
    }
  }
  __syncthreads();
  if (blockIdx.x == 0 && tid < 2 * kBM && row0 + tid % kBM < m)
    (tid < kBM ? nnz_out : empty_out)[row0 + tid % kBM] = row_cnt[tid];

  // the tile: the warps' partials added in warp order, then the LIF step;
  // every v and elapsed load comes before the first store
  constexpr int kEl = cdiv(kBM * kBN, kThreads);
  float v0[kEl], cur[kEl];
  int el0[kEl];
  bool hit[kEl];
#pragma unroll
  for (int i = 0; i < kEl; ++i) {
    const int e = i * kThreads + tid, r = e / kBN, q = e % kBN;
    const int row = row0 + r, col = col0 + q;
    const bool ok = e < kBM * kBN && row < m && col < n;
    const size_t o = (size_t)row * n + col;
    v0[i] = ok ? v[o] : 0.f;
    el0[i] = ok && kPartialUpdate ? elapsed[o] : 0;
    double sum = 0.0;
    uint32_t rows_hit = 0u;
    if (e < kBM * kBN) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sum += partial[w * kBM * kBN + e];
        rows_hit |= pmask[w * kBN + q];
      }
    }
    cur[i] = (float)sum;
    hit[i] = all_nonzero ? row_cnt[r % kBM] > 0 : (rows_hit >> r % kBM) & 1u;
  }
#pragma unroll
  for (int i = 0; i < kEl; ++i) {
    const int e = i * kThreads + tid;
    const int row = row0 + e / kBN, col = col0 + e % kBN;
    if (e < kBM * kBN && row < m && col < n)
      lif_store<kPartialUpdate>((size_t)row * n + col, v0[i], el0[i], cur[i],
                                hit[i], v, elapsed, spikes, touched,
                                threshold, leak, reset);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <bool kPartialUpdate>
cudaError_t launch_dense(const void* packed, const void* weights, void* v,
                         void* elapsed, void* spikes, void* touched,
                         void* nnz, void* empty, int m, int kw, int n,
                         float threshold, float leak, float reset,
                         int all_nonzero, cudaStream_t stream) {
  const size_t smem = (size_t)kw * 16 * sizeof(uint16_t);
  auto kernel = fused_timestep_dense_kernel<kPartialUpdate>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(cdiv(n, kDenseN), m);
  kernel<<<grid, kDenseN, smem, stream>>>(
      static_cast<const uint16_t*>(packed),
      static_cast<const float*>(weights), static_cast<float*>(v),
      static_cast<int*>(elapsed), static_cast<float*>(spikes),
      static_cast<int*>(touched), static_cast<int*>(nnz),
      static_cast<int*>(empty), kw, n, threshold, leak, reset, all_nonzero);
  return cudaGetLastError();
}

template <int kNT, bool kVec, bool kPartialUpdate>
cudaError_t launch_codebook(const void* packed, const void* idx,
                            const void* cbw, void* v, void* elapsed,
                            void* spikes, void* touched, void* nnz,
                            void* empty, int m, int kw, int n, int n_levels,
                            int smem, float threshold, float leak,
                            float reset, int all_nonzero,
                            cudaStream_t stream) {
  auto kernel = fused_timestep_codebook_kernel<kNT, kVec, kPartialUpdate>;
  // above 48 KB a kernel must opt in; the attribute is per device, so it
  // is set on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, 8 * kNT), cdiv(m, kBM));
  kernel<<<grid, Shape<kNT>::kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(packed), static_cast<const int8_t*>(idx),
      static_cast<const float*>(cbw), static_cast<float*>(v),
      static_cast<int*>(elapsed), static_cast<float*>(spikes),
      static_cast<int*>(touched), static_cast<int*>(nnz),
      static_cast<int*>(empty), m, kw, n, n_levels, threshold, leak, reset,
      all_nonzero);
  return cudaGetLastError();
}

template <int kNT>
cudaError_t launch_codebook(int partial_update, const void* packed,
                            const void* idx, const void* cbw, void* v,
                            void* elapsed, void* spikes, void* touched,
                            void* nnz, void* empty, int m, int kw, int n,
                            int n_levels, int smem, float threshold,
                            float leak, float reset, int all_nonzero,
                            cudaStream_t s) {
  // cp.async copies need rows and base aligned to the tile's bytes
  const bool vec =
      n % (8 * kNT) == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
#define FUSED_LAUNCH(kVec, kPartial)                                         \
  return launch_codebook<kNT, kVec, kPartial>(                               \
      packed, idx, cbw, v, elapsed, spikes, touched, nnz, empty, m, kw, n,   \
      n_levels, smem, threshold, leak, reset, all_nonzero, s)
  if (vec) {
    if (partial_update) FUSED_LAUNCH(true, true);
    FUSED_LAUNCH(true, false);
  }
  if (partial_update) FUSED_LAUNCH(false, true);
  FUSED_LAUNCH(false, false);
#undef FUSED_LAUNCH
}

}  // namespace

extern "C" {

// The plan (`fused_timestep.py` `_plan`): output tiles of (32, bn) columns,
// bn in {8, 16}, and `smem` bytes of shared memory, at least
// smem_bytes(bn, n_levels).
int fused_timestep_codebook_launch(
    const void* packed, const void* idx, const void* cbw, void* v,
    void* elapsed, void* spikes, void* touched, void* nnz, void* empty,
    int m, int kw, int n, int n_levels, int bn, int smem, float threshold,
    float leak, float reset, int partial_update, int all_nonzero,
    void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return (int)cudaSuccess;
  if (m > 65535 || kw * 16 > 65536 || n_levels <= 0 ||
      (bn != 8 && bn != 16) || smem < smem_bytes(bn, n_levels) ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(bn == 16 ? launch_codebook<2>(
                              partial_update, packed, idx, cbw, v, elapsed,
                              spikes, touched, nnz, empty, m, kw, n, n_levels,
                              smem, threshold, leak, reset, all_nonzero, s)
                        : launch_codebook<1>(
                              partial_update, packed, idx, cbw, v, elapsed,
                              spikes, touched, nnz, empty, m, kw, n, n_levels,
                              smem, threshold, leak, reset, all_nonzero, s));
}

int fused_timestep_dense_launch(
    const void* packed, const void* weights, void* v, void* elapsed,
    void* spikes, void* touched, void* nnz, void* empty, int m, int kw,
    int n, float threshold, float leak, float reset, int partial_update,
    int all_nonzero, void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return (int)cudaSuccess;
  if (m > 65535 || kw * 16 > 65536) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (partial_update)
    return (int)launch_dense<true>(packed, weights, v, elapsed, spikes,
                                   touched, nnz, empty, m, kw, n, threshold,
                                   leak, reset, all_nonzero, s);
  return (int)launch_dense<false>(packed, weights, v, elapsed, spikes,
                                  touched, nnz, empty, m, kw, n, threshold,
                                  leak, reset, all_nonzero, s);
}

const char* fused_timestep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
