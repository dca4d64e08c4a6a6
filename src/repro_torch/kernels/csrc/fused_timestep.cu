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
// weight rows some spike reaches (1 - 0.9^32 of them): about 9.2 MB of
// index rows (codebook) or 37 MB of f32 rows (dense), plus about 3.1 MB of
// v / elapsed / spikes / touched traffic, about 3.7 or 12 us; layer 2
// (4096 -> 1024) about 5 or 17 MB, about 1.5 or 5 us.
//
// One kernel body serves both variants, a template on the source of its B
// operand (`Codebook` or `Dense` below).  A block owns a (32, BN) output
// tile over all of K, BN / 8 n8 tiles of the f64 product; the wrapper's
// `_plan` picks BN 16 where that still gives about one block per SM, else
// BN 8, and the kernel trusts it.  BN = 8 runs 512 threads, BN = 16 256.
// Per chunk of 256 spike words it reads the 32 rows' words (each thread's
// loads in flight at once); a warp per pair of word columns turns lane r's
// 32 bits (row r) into lane j's 32-row mask of k = 32 p + j by five
// butterfly swaps and ballots which of those k any row reaches; the
// reached k are compacted into an ascending list.  Only those weight rows
// w[k, col0:col0+BN] are streamed, by cp.async with their row masks beside
// them, through a ring of one row per thread and stage, so each reached
// row leaves L2 once per 32-row tile, not once per spiking row (a warp's
// copies cover whole rows).  The adds run on the f64 tensor cores
// (mma.sync m16n8k16): warp w takes k-steps w and
// w + warps of each stage; A is 1 or 0 from the row masks, B the row's
// weights as f64.  The touched mask of a column is the OR of the row masks
// of the k whose weight is not +-0, so the touch flags need no second
// product.  The warps' f64 partial tiles are added in warp order and
// rounded once to f32, so two runs are bitwise equal.  One launch per call,
// no memset, no scratch.  At M = 32 and density 0.10 the dense 32-row
// product does ten times the adds the spiking (row, k) pairs need; on the
// tensor cores that still cost less than walking only the pairs on the
// CUDA cores (per-pair loads and conversions set the pace there), and a
// split of the words over a thread-block cluster lost to one block per
// tile (cluster placement left SMs with two blocks beside idle ones).
//
// The sources.  Codebook: 8- or 16-byte int8 index rows in an eight-stage
// ring; the tile's level table is staged once, as f64, with a zero level
// that every index outside [0, L) selects (int8 reaches only levels
// 0..127, so at most 128 levels are staged), and B is the level each
// index selects.  Dense (float simulators): f32 rows of 4 BN bytes, whole
// 32-byte sectors, in a ring of three stages at BN 16 (two blocks of 256
// threads share an SM, as two codebook blocks do) or four at BN 8, their
// n8 tiles swizzled so a B load's four rows start in four bank groups; B
// is cvt.f64.f32 of the weight, exact, so +-0 stays +-0.  A tile of 32
// columns (whole 128-byte lines, one block of 256 threads per SM) lost to
// BN 16 at both M = 32 and 640.
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

constexpr int kBM = 32;                    // a k's row mask is one word
constexpr int kMTiles = kBM / 16;          // m16 tiles of the f64 product
constexpr int kChunkWords = 256;           // spike words listed at once
constexpr int kChunk = kChunkWords * 16;   // their k
constexpr int kWordsLd = kChunkWords + 2;  // a row of staged words, padded:
                                           // lane = row hits 32 banks
constexpr int kSegs = kChunk / 32;         // 32-k segments of a chunk
constexpr int kBatch = 8;                  // global loads a thread has in
                                           // flight while staging
constexpr int kMaxLevels = 128;            // int8 reaches levels 0..127
constexpr int kSmemMax = 232448;           // an H100 block's shared memory
static_assert(kSegs == 4 * 32, "a lane of warp 0 scans four segments");

// A block of a tile one n8 tile wide has 512 threads, two wide 256: a
// stage holds a weight row per thread, two k-steps of 16 for each warp.
__host__ __device__ constexpr int block_threads(int bn) {
  return bn == 8 ? 512 : 256;
}
template <int kNT>
struct Shape {
  static constexpr int kThreads = block_threads(8 * kNT);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSK = kThreads;  // weight rows per stage
  static_assert(kSK / 16 == 2 * kWarps, "two k-steps of a stage per warp");
};

// ---------------------------------------------------------------------------
// the B operand's sources: a staged row's bytes, and the f64 values a lane
// takes from it.  Lane (g, t) of the product takes column 8 nt + g of each
// n8 tile nt.
// ---------------------------------------------------------------------------

// int8 index rows; B is the level an index selects in the tile's f64 level
// table ([column][level], ls + 1 levels, the last one zero).
struct Codebook {
  using Elem = int8_t;
  static constexpr bool kTable = true;
  // ring stages: seven in flight
  __host__ __device__ static constexpr int stages(int) { return 8; }
  // staged row bytes (BN <= 16): the four rows of a B load start in four
  // banks
  __host__ __device__ static constexpr int ld(int) { return 16; }
  // blocks an SM holds, at 128 registers a thread
  __host__ __device__ static constexpr int min_blocks(int bn) {
    return 65536 / (block_threads(bn) * 128);
  }
  // the slot of n8 tile nt in staged row r: rows are not permuted
  __device__ __forceinline__ static int slot(int, int nt, int) { return nt; }
  template <int kNT>
  __device__ __forceinline__ static void fetch(double (&b)[kNT],
                                               const uint8_t* row, int g,
                                               const double* table, int lp,
                                               uint32_t ls, int) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      // index bytes past ls, which every negative int8 is as unsigned,
      // select the zero level
      const uint32_t ix = row[8 * nt + g];
      b[nt] = table[(8 * nt + g) * lp + min(ix, ls)];
    }
  }
  // a row whose columns are not all in bounds or not aligned: byte loads of
  // its columns before N, all in flight together
  template <int kBN>
  __device__ __forceinline__ static void load_row(uint8_t* dst,
                                                  const Elem* src, int col0,
                                                  int n, int) {
    uint8_t x[kBN];
#pragma unroll
    for (int c = 0; c < kBN; ++c)
      x[c] = col0 + c < n ? (uint8_t)src[c] : (uint8_t)0;
#pragma unroll
    for (int c = 0; c < kBN; ++c) dst[c] = x[c];
  }
};

// f32 weight rows; B is the weight, converted exactly to f64.
struct Dense {
  using Elem = float;
  static constexpr bool kTable = false;
  // ring stages of 16 KB of rows: BN 16 keeps three, so that two blocks
  // of 256 threads fit an SM, BN 8 (512 threads, one block) four
  __host__ __device__ static constexpr int stages(int bn) {
    return bn == 16 ? 3 : 4;
  }
  // staged row bytes: 4 BN, unpadded (`slot` spreads the banks)
  __host__ __device__ static constexpr int ld(int bn) { return 4 * bn; }
  // blocks an SM holds: two at BN 16 (128 registers a thread)
  __host__ __device__ static constexpr int min_blocks(int bn) {
    return bn == 16 ? 2 : 1;
  }
  // The slot of n8 tile nt in staged row r, so that the four rows of a B
  // load (r = t + 4 v, t < 4) start in four groups of eight banks: the two
  // tiles of a 64-byte row swap places where bit 1 of r is set (a 32-byte
  // row spreads them as it is).
  __device__ __forceinline__ static int slot(int r, int nt, int n_tiles) {
    return n_tiles == 2 ? nt ^ (r >> 1 & 1) : nt;
  }
  template <int kNT>
  __device__ __forceinline__ static void fetch(double (&b)[kNT],
                                               const uint8_t* row, int g,
                                               const double*, int, uint32_t,
                                               int r) {
    const float* w = reinterpret_cast<const float*>(row) + g;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      b[nt] = (double)w[8 * slot(r, nt, kNT)];
  }
  // a row that is not 16-byte aligned or runs past N: 4-byte copies of its
  // columns, zero past N
  template <int kBN>
  __device__ __forceinline__ static void load_row(uint8_t* dst,
                                                  const Elem* src, int col0,
                                                  int n, int r) {
#pragma unroll
    for (int c = 0; c < kBN; ++c) {
      const bool in = col0 + c < n;
      hopper::cp_async4(dst + 4 * (8 * slot(r, c / 8, kBN / 8) + c % 8),
                        in ? src + c : src, in ? 4 : 0);
    }
  }
};

// Bytes of the block's shared memory: the level table (codebook) and the
// ring of weight rows and their row masks, which the warps' f64 partial
// tiles and touched masks reuse after the loop; then the staged spike
// words, the chunk's row masks and k-list, the segment counts and the
// per-row spike and empty-word counts.
// `fused_timestep.py` `_smem_bytes` computes the same.
template <class Src>
__host__ __device__ constexpr int region_bytes(int bn, int ls) {
  return (Src::kTable ? (ls + 1) * bn * 8 : 0) +
                     Src::stages(bn) * block_threads(bn) * (Src::ld(bn) + 4) >
                 block_threads(bn) / 32 * (kBM * bn * 8 + bn * 4)
             ? (Src::kTable ? (ls + 1) * bn * 8 : 0) +
                   Src::stages(bn) * block_threads(bn) * (Src::ld(bn) + 4)
             : block_threads(bn) / 32 * (kBM * bn * 8 + bn * 4);
}
constexpr int kFixedBytes = kBM * kWordsLd * 2 + kChunk * 4 + kChunk * 2 +
                            kSegs * 4 * 2 + 2 * kBM * 4 + 16;
template <class Src>
__host__ __device__ constexpr int smem_bytes(int bn, int n_levels) {
  return region_bytes<Src>(bn,
                           n_levels < kMaxLevels ? n_levels : kMaxLevels) +
         kFixedBytes;
}

// start stage `st` of the chunk (list entries st * kSK ..) into `dst`, row r
// at r * ld: with kVec, copies of up to 16 bytes, piece e of the stage from
// row e / pieces, so a warp's copies cover whole rows; else a row per
// thread by `Src::load_row`.  Thread r writes row r's mask into `dmask`.  A
// row past the list gets mask 0 and a copy of the list's last row, so it
// adds +-0 and touches nothing.
template <class Src, int kNT, bool kVec>
__device__ __forceinline__ void load_stage(
    const typename Src::Elem* __restrict__ w, uint8_t* dst, uint32_t* dmask,
    const uint16_t* list, const uint32_t* kmask, int st, int n_reach, int k0,
    int col0, int n) {
  using Elem = typename Src::Elem;
  constexpr int kBN = 8 * kNT, kSK = Shape<kNT>::kSK;
  constexpr int kLd = Src::ld(kBN);
  constexpr int kRow = kBN * (int)sizeof(Elem);     // bytes of a row
  constexpr int kPiece = kRow < 16 ? kRow : 16;     // bytes of a copy
  constexpr int kPieces = kRow / kPiece;            // copies per row
  constexpr int kPieceElems = kPiece / (int)sizeof(Elem);
  const int tid = threadIdx.x;
  {
    const int j = st * kSK + tid;
    dmask[tid] = j < n_reach ? kmask[list[j]] : 0u;
  }
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int e = i * kSK + tid, r = e / kPieces, q = e % kPieces;
      const int j = min(st * kSK + r, n_reach - 1);
      const int c0 = q * kPieceElems;  // its first column in the tile
      uint8_t* d = dst + r * kLd +
                   (Src::slot(r, c0 / 8, kNT) * 8 + c0 % 8) * (int)sizeof(Elem);
      // a piece lies wholly before or past N (N is a multiple of the
      // piece); its n8 tile goes to the row's `slot` for it
      const Elem* row = w + (size_t)(k0 + list[j]) * n + col0;
      const bool in = col0 + (q + 1) * kPieceElems <= n;
      if constexpr (kPiece == 16)
        hopper::cp_async16(d, in ? row + q * kPieceElems : row, in ? 16 : 0);
      else
        hopper::cp_async8(d, in ? row + q * kPieceElems : row, in ? 8 : 0);
    }
  } else {
    const int j = min(st * kSK + tid, n_reach - 1);
    Src::template load_row<kBN>(dst + tid * kLd,
                                w + (size_t)(k0 + list[j]) * n + col0, col0,
                                n, tid);
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
// product of the 32 rows' 0/1 spikes at the k-step's 16 k with the weights
// of those k.  Lane (g, t)'s operands take stage rows j = 16 s + t + 4 v:
// b, for each n8 tile, is j's weight at the tile's column g as the source
// gives it, and a, for m16 tile i, is 1 or 0 as row 16 i + g + 8 h's bit in
// j's mask is set.  The touched mask of the column ORs j's row mask where
// the weight is not +-0.  A warp whose first k-step lies past the list
// (`rows` rows of the stage are listed) adds nothing; its second may, and
// then adds the padding rows' +-0.  Each k-step is fetched and added in
// turn, so the first one's products issue while the second one's operands
// are loaded and converted.
template <class Src, int kNT>
__device__ __forceinline__ void add_stage(
    double (&acc)[kNT][kMTiles][4], uint32_t (&tmask)[kNT],
    const uint8_t* raw, const uint32_t* smask, const double* table, int rows,
    uint32_t ls, int warp, int lane) {
  constexpr int kWarps = Shape<kNT>::kWarps, kLd = Src::ld(8 * kNT);
  if (16 * warp >= rows) return;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    uint32_t m4[4];
    double b[4][kNT];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = 16 * (warp + kWarps * h2) + t + 4 * v;
      m4[v] = smask[j];
      Src::template fetch<kNT>(b[v], raw + j * kLd, g, table, (int)ls + 1,
                               ls, j);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        if (__double2hiint(b[v][nt]) & 0x7fffffff) tmask[nt] |= m4[v];
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
      double a[8];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          // 1.0 or 0.0 by its high word: no int-to-f64 conversion
          a[2 * v + h] = __hiloint2double(
              m4[v] & 1u << (16 * i + g + 8 * h) ? 0x3FF00000 : 0, 0);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const double bv[4] = {b[0][nt], b[1][nt], b[2][nt], b[3][nt]};
        hopper::dmma(acc[nt][i], a, bv);
      }
    }
  }
}

template <class Src, int kNT, bool kVec, bool kPartialUpdate>
__global__ void __launch_bounds__(Shape<kNT>::kThreads,
                                  Src::min_blocks(8 * kNT))
    fused_timestep_kernel(
    const uint16_t* __restrict__ packed,          // (M, Kw)
    const typename Src::Elem* __restrict__ w,     // (16*Kw, N)
    const float* __restrict__ cbw,                // (L, N), codebook only
    float* __restrict__ v,                        // (M, N) in place
    int* __restrict__ elapsed,                    // (M, N) in place
    float* __restrict__ spikes,                   // (M, N)
    int* __restrict__ touched,                    // (M, N)
    int* __restrict__ nnz_out,                    // (M,)
    int* __restrict__ empty_out,                  // (M,)
    int m, int kw, int n, int n_levels, float threshold, float leak,
    float reset, int all_nonzero) {
  constexpr int kBN = 8 * kNT, kStages = Src::stages(kBN);
  constexpr int kThreads = Shape<kNT>::kThreads, kWarps = Shape<kNT>::kWarps;
  constexpr int kSK = Shape<kNT>::kSK;
  constexpr int kStage = kSK * Src::ld(kBN);  // bytes
  extern __shared__ __align__(128) uint8_t smem[];
  const int ls = Src::kTable ? min(n_levels, kMaxLevels) : 0;
  double* table = reinterpret_cast<double*>(smem);
  uint8_t* ring = smem + (Src::kTable ? (ls + 1) * kBN * 8 : 0);
  uint32_t* ring_mask = reinterpret_cast<uint32_t*>(ring + kStages * kStage);
  double* partial = reinterpret_cast<double*>(smem);  // after the loop
  uint32_t* pmask =
      reinterpret_cast<uint32_t*>(smem + kWarps * kBM * kBN * 8);
  uint16_t* words =
      reinterpret_cast<uint16_t*>(smem + region_bytes<Src>(kBN, ls));
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

    // stream the reached weight rows and add; a level table is staged
    // once, while the first stages are in flight
    const int n_st = cdiv(n_reach, kSK);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_st)
        load_stage<Src, kNT, kVec>(w, ring + s * kStage, ring_mask + s * kSK,
                                   klist, kmask, s, n_reach, k0, col0, n);
      hopper::cp_async_commit();
    }
    if constexpr (Src::kTable)
      if (c0w == 0) stage_table<kNT>(table, cbw, ls, col0, n);
    for (int st = 0; st < n_st; ++st) {
      hopper::cp_async_wait<kStages - 2>();  // stage st has landed
      __syncthreads();  // ... for every thread; stage st - 1 was added
      {
        const int nxt = st + kStages - 1;
        if (nxt < n_st)
          load_stage<Src, kNT, kVec>(w, ring + (nxt % kStages) * kStage,
                                     ring_mask + (nxt % kStages) * kSK,
                                     klist, kmask, nxt, n_reach, k0, col0, n);
        hopper::cp_async_commit();
      }
      add_stage<Src, kNT>(acc, tmask, ring + (st % kStages) * kStage,
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

template <class Src, int kNT, bool kVec, bool kPartialUpdate>
cudaError_t launch_tiles(const void* packed, const void* w, const void* cbw,
                         void* v, void* elapsed, void* spikes, void* touched,
                         void* nnz, void* empty, int m, int kw, int n,
                         int n_levels, int smem, float threshold, float leak,
                         float reset, int all_nonzero, cudaStream_t stream) {
  auto kernel = fused_timestep_kernel<Src, kNT, kVec, kPartialUpdate>;
  // above 48 KB a kernel must opt in; the attribute is per device, so it
  // is set on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, 8 * kNT), cdiv(m, kBM));
  kernel<<<grid, Shape<kNT>::kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(packed),
      static_cast<const typename Src::Elem*>(w),
      static_cast<const float*>(cbw), static_cast<float*>(v),
      static_cast<int*>(elapsed), static_cast<float*>(spikes),
      static_cast<int*>(touched), static_cast<int*>(nnz),
      static_cast<int*>(empty), m, kw, n, n_levels, threshold, leak, reset,
      all_nonzero);
  return cudaGetLastError();
}

template <class Src, int kNT>
cudaError_t launch_tiles(int partial_update, const void* packed,
                         const void* w, const void* cbw, void* v,
                         void* elapsed, void* spikes, void* touched,
                         void* nnz, void* empty, int m, int kw, int n,
                         int n_levels, int smem, float threshold, float leak,
                         float reset, int all_nonzero, cudaStream_t s) {
  // cp.async copies need the weights 16-byte aligned and N a multiple of
  // a copy (a codebook row of BN bytes, four f32), so each copy lies
  // wholly before or past N and rows stay aligned
  constexpr int kElem = sizeof(typename Src::Elem);
  constexpr int kPieceElems = 8 * kNT * kElem < 16 ? 8 * kNT : 16 / kElem;
  const bool vec =
      n % kPieceElems == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define FUSED_LAUNCH(kVec, kPartial)                                         \
  return launch_tiles<Src, kNT, kVec, kPartial>(                             \
      packed, w, cbw, v, elapsed, spikes, touched, nnz, empty, m, kw, n,     \
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
// smem_bytes<Codebook>(bn, n_levels).
int fused_timestep_codebook_launch(
    const void* packed, const void* idx, const void* cbw, void* v,
    void* elapsed, void* spikes, void* touched, void* nnz, void* empty,
    int m, int kw, int n, int n_levels, int bn, int smem, float threshold,
    float leak, float reset, int partial_update, int all_nonzero,
    void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return (int)cudaSuccess;
  if (m > 65535 || kw * 16 > 65536 || n_levels <= 0 ||
      (bn != 8 && bn != 16) || smem < smem_bytes<Codebook>(bn, n_levels) ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define CODEBOOK_LAUNCH(kNT)                                                 \
  launch_tiles<Codebook, kNT>(partial_update, packed, idx, cbw, v, elapsed,  \
                              spikes, touched, nnz, empty, m, kw, n,         \
                              n_levels, smem, threshold, leak, reset,        \
                              all_nonzero, s)
  return (int)(bn == 16 ? CODEBOOK_LAUNCH(2) : CODEBOOK_LAUNCH(1));
#undef CODEBOOK_LAUNCH
}

// The plan (`fused_timestep.py` `_plan` with no levels): output tiles of
// (32, bn) columns, bn in {8, 16}, and `smem` bytes of shared memory, at
// least smem_bytes<Dense>(bn, 0).
int fused_timestep_dense_launch(
    const void* packed, const void* weights, void* v, void* elapsed,
    void* spikes, void* touched, void* nnz, void* empty, int m, int kw,
    int n, int bn, int smem, float threshold, float leak, float reset,
    int partial_update, int all_nonzero, void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return (int)cudaSuccess;
  if (m > 65535 || kw * 16 > 65536 || (bn != 8 && bn != 16) ||
      smem < smem_bytes<Dense>(bn, 0) || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define DENSE_LAUNCH(kNT)                                                    \
  launch_tiles<Dense, kNT>(partial_update, packed, weights, nullptr, v,      \
                           elapsed, spikes, touched, nnz, empty, m, kw, n, 0, \
                           smem, threshold, leak, reset, all_nonzero, s)
  return (int)(bn == 16 ? DENSE_LAUNCH(2) : DENSE_LAUNCH(1));
#undef DENSE_LAUNCH
}

const char* fused_timestep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
