// Range probe for NVIDIA Hopper (sm_90a): routed (gathered) and dense.
//
// Replaces the eight Pallas TPU kernels of
// src/repro/kernels/range_probe/kernel.py, each with its alive variant.
// Routed counts, tile-major (rp_group_pairs, then rp_tile_counts):
//   gather_count_pallas       (_gather_count_kernel, _gather_count_alive_kernel)
//   gather_count_skip_pallas  (_gather_count_skip_kernel, ..._alive_kernel)
// Routed hit lists, tile-major (rp_group_pairs, then rp_tile_hits to
// count and, after a scan, rp_tile_hits to emit), the function the
// serving path needs from:
//   gather_mask_pallas        (_gather_mask_kernel, _gather_mask_alive_kernel)
//   gather_mask_skip_pallas   (_gather_mask_skip_kernel, ..._alive_kernel)
// Routed masks, a warp per pair (rp_gathered_mask): the same two TPU
// kernels' (Q, F, cap) table itself, with no serving caller.
// Dense (all-tile) entry points, rp_dense_probe:
//   count_pallas              (_count_kernel, _count_alive_kernel)
//   mask_pallas               (_mask_kernel, _mask_alive_kernel)
//   count_skip_pallas         (_count_skip_kernel, _count_skip_alive_kernel)
//   mask_skip_pallas          (_mask_skip_kernel, _mask_skip_alive_kernel)
// Three templated kernels, instantiated for skip/no-skip x alive/none
// (and count/mask for the dense one, pair count/segment count/emit for
// the tile-major one), compute what
// repro/kernels/range_probe/ref.py computes (gathered_* and probe_*
// with their chunk-masked *_skip twins).
//
// What every routed kernel differs in from the TPU kernels:
// - No gathered stack.  The TPU path materialises (Q, F, 4, cap) member
//   boxes before the call; here the kernels read cand[q, f] themselves
//   and index the row-major (T, cap, 4) canonical tiles directly, one
//   float4 per slot.  A candidate outside [0, T) (the -1 padding) gives
//   zero hits and an all-false mask row, as the reference's appended
//   sentinel row does.  Queries are not padded; cap need not be a
//   multiple of 128: the ragged last chunk is masked.
// - Skip per query.  Pallas skips a chunk only when no query of its
//   128-query block hits the chunk box; here a query that misses a
//   chunk box takes no hits from the chunk, as the chunk-masked ref
//   oracles define, so the bits equal ref even for chunk boxes that do
//   not bound their members.
//
// Routed counts.  A batch's F is its widest fan-out, ratcheted, so most
// (query, candidate) pairs are -1 padding, and the live pairs of a tile
// are many queries probing the same member boxes.  Three small kernels
// group the live pairs by tile (a histogram with ranks, one block's
// scan over the tiles, a scatter of pair indices) and zero the counts;
// then a persistent grid of blocks takes work items, each one (tile,
// run of up to 128 of its pairs, segment of 8,192 slots), one pair to
// one or more threads, so a tile's alive flags, chunk boxes and member
// boxes are read once per run instead of once per pair, no block walks
// a long tile alone, and short runs still fill a block's warps.  Each
// thread adds its hits to its pair's count with one integer atomic.
// With an alive mask, the walk stops at the tile's live extent (1 +
// its last alive slot, passed in by the caller): padding sits at each
// tile's tail, and under the local index the canonical members are a
// prefix, so the extent is a few percent of cap.  Without an alive mask
// every slot of cap counts, as in the reference.  Counts are integer
// sums of per-pair hits, so the grouping changes no bit.
//
// Bound on the H100: bytes.  A run reads its tile's alive flags up to
// the extent, the chunk boxes up to the extent and the boxes of alive
// slots in live chunks, and writes 4 B a pair; four float compares per
// (pair, alive slot) are well below the float32 rate.
//
// Routed hit lists.  The serving path needs every hit of every (query,
// candidate) pair as (query, tile, slot), in the reference's flat
// (query, candidate, slot) order, not the (Q, F, cap) table, which is
// almost all zeros (F is ratcheted, most pairs are -1, and a tile's
// live extent is a few percent of cap).  The same grouping and the
// same work items as the routed counts, in three passes:
//   1. count: the tile-major probe writes each (pair, segment)'s hits
//      to its own cell of a zeroed (Q, F, S) array, S = ceil(cap /
//      kSegSlots) (threads that share a pair in one work item meet in
//      integer atomics on a cell no other item writes);
//   2. scan: the caller's inclusive scan of the flat (Q, F, S) array;
//      a pair's segments are in slot order, so cell (pair, s) starts
//      at its scan minus its count in the flat order, and the last
//      element sizes the output;
//   3. emit: the same probe again; a warp takes one pair of the run at
//      a time and walks the step's compacted boxes (under the skip,
//      only the chunks its query reaches) 32 at a time, a ballot and a
//      __popc prefix placing each hit after the pair's earlier ones, so
//      the output is deterministic and in ascending slot order.
// Both passes decide a hit by the same code on the same compacted
// boxes, so a cell's count is exactly the number of hits it emits.
// Bound on the H100: bytes, the count pass's reads at the extent once
// plus the hits written (3 x 8 bytes each).
//
// Routed masks.  One warp owns one (query, candidate) pair: lane c
// tests chunk box c, a ballot gives the warp-uniform set of live
// chunks, and only those chunks' member boxes are read; a lane reads a
// slot's box only when the slot is alive.  Bound by bytes: the
// (Q, F, cap) output, written in full, skipped chunks included, so the
// wrapper allocates it with torch.empty.
//
// Dense design.  The TPU grid streams one tile against one 128-query
// block per cell; here one thread block owns one (tile, 128-query
// block) and one thread owns one query, so a tile is read once per
// query block instead of once per query.  The block walks the tile a
// chunk (128 slots) at a time:
//   1. (skip) each thread tests its query against chunk box c; a chunk
//      that no query of the block hits is skipped whole, and a query
//      that misses it takes no hits from it (per-query predication);
//   2. each thread reads one alive byte; a ballot and popc compact the
//      alive slots' float4 boxes into shared memory, in slot order, so
//      a dead or non-canonical slot costs one byte and an all-dead
//      chunk costs 128;
//   3. each thread tests its query against the compacted boxes.
// Counts accumulate in a register and are written once per (query,
// tile).  Masks are (Q, T, cap), query-major as repro's ops return
// them: each thread keeps a 128-bit hit bitmap per chunk, and each
// warp then writes its 32 queries' rows of the chunk, one row at a
// time, 128 contiguous bytes per store instruction when cap % 4 == 0.
// Skipped chunks and dead slots are written False, so every byte of
// the output is written.  Neither Q nor cap need be a multiple of 128.
//
// Bound on the H100: dense counts are bound by operations (four
// compares per (query, alive slot)), dense masks by their output
// (Q * T * cap bytes).  No FMA or other floating-point arithmetic is
// done: the hit test is four compares.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kChunk = 128;
constexpr int kWarps = 8;  // (query, candidate) pairs per block

__device__ __forceinline__ bool hit(const float4 q, const float4 s) {
  return (q.x <= s.z) & (s.x <= q.z) & (q.y <= s.w) & (s.y <= q.w);
}

template <bool SKIP, bool ALIVE>
__global__ void __launch_bounds__(kWarps * 32)
gathered_probe(const float4* __restrict__ q, const float4* __restrict__ tiles,
               const float4* __restrict__ cboxes,
               const uint8_t* __restrict__ alive,
               const int32_t* __restrict__ cand, int64_t pairs, int F, int T,
               int cap, int C, uint8_t* __restrict__ mask) {
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= pairs) return;  // warp-uniform: a warp owns one pair
  const int t = cand[pair];
  const float4 qb = q[pair / F];
  uint8_t* mrow = mask + pair * cap;

  if (t < 0 || t >= T) {  // padding candidate: no hits
    for (int s = lane; s < cap; s += 32) mrow[s] = 0;
    return;
  }
  const float4* trow = tiles + static_cast<int64_t>(t) * cap;
  const uint8_t* arow = ALIVE ? alive + static_cast<int64_t>(t) * cap : nullptr;
  const float4* crow = SKIP ? cboxes + static_cast<int64_t>(t) * C : nullptr;

  for (int c0 = 0; c0 < C; c0 += 32) {
    unsigned live = 0xffffffffu;
    if (SKIP) {
      const bool l = (c0 + lane < C) && hit(qb, crow[c0 + lane]);
      live = __ballot_sync(0xffffffffu, l);
    }
    const int n = min(C - c0, 32);
    for (int k = 0; k < n; ++k) {
      const int base = (c0 + k) * kChunk;
      const bool on = (live >> k) & 1u;  // warp-uniform
#pragma unroll
      for (int j = 0; j < kChunk / 32; ++j) {
        const int s = base + j * 32 + lane;
        if (s < cap) {
          bool h = false;
          if (on && (!ALIVE || arow[s])) h = hit(qb, trow[s]);
          mrow[s] = h;
        }
      }
    }
  }
}

template <bool SKIP, bool ALIVE>
void launch(const void* q, const void* tiles, const void* cboxes,
            const void* alive, const void* cand, int64_t pairs, int F, int T,
            int cap, int C, void* mask, cudaStream_t stream) {
  const int64_t blocks = (pairs + kWarps - 1) / kWarps;
  gathered_probe<SKIP, ALIVE><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                                stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(tiles),
      static_cast<const float4*>(cboxes), static_cast<const uint8_t*>(alive),
      static_cast<const int32_t*>(cand), pairs, F, T, cap, C,
      static_cast<uint8_t*>(mask));
}

// ---------------------------------------------------------------------------
// dense probe: one block per (tile, 128-query block)
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;  // queries per block, one per thread
constexpr int kWords = kBQ / 32;

template <bool MASK, bool SKIP, bool ALIVE>
__global__ void __launch_bounds__(kBQ)
dense_probe(const float4* __restrict__ q, const float4* __restrict__ tiles,
            const float4* __restrict__ cboxes,
            const uint8_t* __restrict__ alive, int64_t Q, int T, int cap,
            int C, int nqb, int32_t* __restrict__ counts,
            uint8_t* __restrict__ mask) {
  __shared__ float4 s_box[kChunk];
  __shared__ uint8_t s_lane[kChunk];
  __shared__ int s_cnt[kWords];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = static_cast<int>(blockIdx.x / nqb);
  const int64_t q0 = static_cast<int64_t>(blockIdx.x % nqb) * kBQ;
  const int64_t j = q0 + tid;
  const bool qvalid = j < Q;
  const float4 qb = qvalid ? q[j] : make_float4(9e9f, 9e9f, -9e9f, -9e9f);
  const float4* trow = tiles + static_cast<int64_t>(t) * cap;
  const uint8_t* arow = ALIVE ? alive + static_cast<int64_t>(t) * cap : nullptr;
  const float4* crow = SKIP ? cboxes + static_cast<int64_t>(t) * C : nullptr;
  const bool aligned4 = (cap & 3) == 0;

  int acc = 0;
  for (int c = 0; c < C; ++c) {
    const int base = c * kChunk;
    bool qlive = qvalid;
    if (SKIP) qlive = qlive && hit(qb, crow[c]);
    const bool any = SKIP ? __syncthreads_or(qlive) != 0 : true;
    uint32_t bm[kWords] = {0u, 0u, 0u, 0u};
    if (any) {  // block-uniform
      const int s = base + tid;
      const bool a = s < cap && (!ALIVE || arow[s]);
      const unsigned bal = __ballot_sync(0xffffffffu, a);
      if (lane == 0) s_cnt[warp] = __popc(bal);
      __syncthreads();
      int off[kWords], n = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        off[w] = n;
        n += s_cnt[w];
      }
      if (a) {  // compact the alive slots' boxes, in slot order
        const int pos = off[warp] + __popc(bal & ((1u << lane) - 1u));
        s_box[pos] = trow[s];
        s_lane[pos] = static_cast<uint8_t>(lane);
      }
      __syncthreads();
      if (qlive) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const int end = off[w] + s_cnt[w];
          for (int i = off[w]; i < end; ++i) {
            const bool h = hit(qb, s_box[i]);
            if (MASK)
              bm[w] |= static_cast<uint32_t>(h) << s_lane[i];
            else
              acc += h;
          }
        }
      }
      __syncthreads();  // s_box, s_lane and s_cnt are reused next chunk
    }
    if (MASK) {
      // warp w writes this chunk's row segment of each of its 32 queries
      const int valid = min(kChunk, cap - base);
      for (int i = 0; i < 32; ++i) {
        uint32_t b[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          b[w] = __shfl_sync(0xffffffffu, bm[w], i);
        const int64_t jj = q0 + warp * 32 + i;
        if (jj >= Q) continue;  // warp-uniform
        uint8_t* row = mask + (jj * T + t) * static_cast<int64_t>(cap) + base;
        if (aligned4) {  // one 4-byte store per lane: 128 B per warp
          if (4 * lane < valid) {
            const uint32_t word = lane < 8 ? b[0] : lane < 16 ? b[1]
                                  : lane < 24 ? b[2] : b[3];
            const uint32_t nib = (word >> ((4 * lane) & 31)) & 0xfu;
            reinterpret_cast<uint32_t*>(row)[lane] =
                (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
                ((nib & 8u) << 21);
          }
        } else {
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            if (w * 32 + lane < valid)
              row[w * 32 + lane] = static_cast<uint8_t>((b[w] >> lane) & 1u);
        }
      }
    }
  }
  if (!MASK && qvalid) counts[j * T + t] = acc;
}

template <bool MASK, bool SKIP, bool ALIVE>
void launch_dense(const void* q, const void* tiles, const void* cboxes,
                  const void* alive, int64_t Q, int T, int cap, int C,
                  void* counts, void* mask, cudaStream_t stream) {
  const int nqb = static_cast<int>((Q + kBQ - 1) / kBQ);
  const int64_t blocks = static_cast<int64_t>(T) * nqb;
  dense_probe<MASK, SKIP, ALIVE><<<static_cast<unsigned>(blocks), kBQ, 0,
                                   stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(tiles),
      static_cast<const float4*>(cboxes), static_cast<const uint8_t*>(alive),
      Q, T, cap, C, nqb, static_cast<int32_t*>(counts),
      static_cast<uint8_t*>(mask));
}

template <bool MASK, bool SKIP>
void launch_dense_alive(bool has_alive, const void* q, const void* tiles,
                        const void* cboxes, const void* alive, int64_t Q,
                        int T, int cap, int C, void* counts, void* mask,
                        cudaStream_t stream) {
  if (has_alive)
    launch_dense<MASK, SKIP, true>(q, tiles, cboxes, alive, Q, T, cap, C,
                                   counts, mask, stream);
  else
    launch_dense<MASK, SKIP, false>(q, tiles, cboxes, alive, Q, T, cap, C,
                                    counts, mask, stream);
}

// ---------------------------------------------------------------------------
// routed counts, tile-major: the live pairs grouped by candidate tile,
// then blocks that take one (tile, run of up to 128 of its pairs, slot
// segment) at a time
// ---------------------------------------------------------------------------

constexpr int kRun = 128;                      // pairs per run, threads a block
constexpr int kStep = 16 * kRun;               // slots per block step
constexpr int kStepChunks = kStep / kChunk;    // 16
constexpr int kSegSlots = 4 * kStep;           // slots per work item
constexpr int kGroupThreads = 256;
constexpr int kGroupBlocks = 4096;
constexpr int kScanThreads = 1024;

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total receives the block's sum.  s_warp holds blockDim.x / 32 ints.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) s_warp[lane] = w;  // inclusive, per warp
  }
  __syncthreads();
  *total = s_warp[nw - 1];
  const int excl = x - v + (warp ? s_warp[warp - 1] : 0);
  __syncthreads();  // s_warp is reused by the next call
  return excl;
}

// The grouping's scratch, int32, carved from one buffer.
struct Groups {
  int32_t* hist;       // (T,) live pairs per tile
  int32_t* pair_off;   // (T,) first position of each tile's pairs in order
  int32_t* item_off;   // (T,) first work item of each tile
  int32_t* n_items;    // (1,) work items in all
  int32_t* rank;       // (pairs,) a pair's rank among its tile's, -1: padding
  int32_t* order;      // (pairs,) live pair indices in tile order
  int32_t* item_tile;  // (max_items,) the tile of each work item
};

// A tile's slot walk ends at its live extent (with an alive mask and an
// extent) or at cap.
__device__ __forceinline__ int slot_limit(const int32_t* extent, int t,
                                          int cap) {
  return extent ? min(extent[t], cap) : cap;
}

// Work items: (tile, run, segment) for every run of every tile and every
// kSegSlots segment of its slots; sum over tiles of ceil(h / kRun) is at
// most pairs / kRun + (tiles with h > 0).
int64_t max_items(int T, int64_t pairs, int cap) {
  const int64_t runs = (pairs + kRun - 1) / kRun + std::min<int64_t>(T, pairs);
  return runs * ((static_cast<int64_t>(cap) + kSegSlots - 1) / kSegSlots);
}

int64_t scratch_ints(int T, int64_t pairs, int cap) {
  return 3LL * T + 1 + 2 * pairs + max_items(T, pairs, cap);
}

Groups carve(void* scratch, int T, int64_t pairs) {
  int32_t* p = static_cast<int32_t*>(scratch);
  Groups g;
  g.hist = p;
  g.pair_off = p + T;
  g.item_off = p + 2 * static_cast<int64_t>(T);
  g.n_items = p + 3 * static_cast<int64_t>(T);
  g.rank = g.n_items + 1;
  g.order = g.rank + pairs;
  g.item_tile = g.order + pairs;
  return g;
}

// 1. each pair's rank among its tile's pairs, and a zero count where
//    counts is given (the work items add their hits to it); a -1 (or
//    out-of-range) candidate takes no probe work
__global__ void __launch_bounds__(kGroupThreads)
group_rank(const int32_t* __restrict__ cand, int64_t pairs, int T, Groups g,
           int32_t* __restrict__ counts) {
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < pairs; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int t = cand[p];
    g.rank[p] = (t < 0 || t >= T) ? -1 : atomicAdd(&g.hist[t], 1);
    if (counts) counts[p] = 0;
  }
}

// 2. one block: exclusive scans of pairs and work items over the tiles,
//    and the tile of every work item
__global__ void __launch_bounds__(kScanThreads)
group_scan(int T, const int32_t* __restrict__ extent, int cap, Groups g) {
  __shared__ int s_warp[kScanThreads / 32];
  int pairs_before = 0, items_before = 0;
  for (int t0 = 0; t0 < T; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    const int h = t < T ? g.hist[t] : 0;
    const int segs =
        h ? (slot_limit(extent, t, cap) + kSegSlots - 1) / kSegSlots : 0;
    const int items = (h + kRun - 1) / kRun * segs;
    int pairs_sum, items_sum;
    const int po = block_exclusive_scan(h, s_warp, &pairs_sum);
    const int io = block_exclusive_scan(items, s_warp, &items_sum);
    if (t < T) {
      g.pair_off[t] = pairs_before + po;
      g.item_off[t] = items_before + io;
      for (int i = 0; i < items; ++i) g.item_tile[items_before + io + i] = t;
    }
    pairs_before += pairs_sum;
    items_before += items_sum;
  }
  if (threadIdx.x == 0) *g.n_items = items_before;
}

// 3. each live pair to its place in tile order (the order within a tile
//    is the atomics'; a pair's count does not depend on it)
__global__ void __launch_bounds__(kGroupThreads)
group_scatter(const int32_t* __restrict__ cand, int64_t pairs, Groups g) {
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < pairs; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int r = g.rank[p];
    if (r >= 0) g.order[g.pair_off[cand[p]] + r] = static_cast<int32_t>(p);
  }
}

// 0x01 in each of the low n bytes of a word (n clamped to [0, 4])
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return n >= 4 ? 0x01010101u
                : n <= 0 ? 0u : 0x01010101u & ((1u << (8 * n)) - 1u);
}

// Hits of query box qb among every stride-th box of s_box[beg, end),
// four independent boxes an iteration so the shared loads overlap.
__device__ __forceinline__ int count_range(const float4 qb,
                                           const float4* s_box, int beg,
                                           int end, int stride) {
  int acc = 0, i = beg;
  for (; i + 3 * stride < end; i += 4 * stride) {
    const bool h0 = hit(qb, s_box[i]);
    const bool h1 = hit(qb, s_box[i + stride]);
    const bool h2 = hit(qb, s_box[i + 2 * stride]);
    const bool h3 = hit(qb, s_box[i + 3 * stride]);
    acc += h0 + h1 + h2 + h3;
  }
  for (; i < end; i += stride) acc += hit(qb, s_box[i]);
  return acc;
}

// Hits of query box qb among all of s_box[beg, end), walked from mid and
// wrapping to beg, so lanes that start at different boxes read
// different banks.
__device__ __forceinline__ int count_rotated(const float4 qb,
                                             const float4* s_box, int beg,
                                             int mid, int end) {
  const int nb = end - beg;
  int acc = 0, k = 0;
  for (; k + 3 < nb; k += 4) {
    int i0 = mid + k, i1 = i0 + 1, i2 = i0 + 2, i3 = i0 + 3;
    i0 -= i0 >= end ? nb : 0;
    i1 -= i1 >= end ? nb : 0;
    i2 -= i2 >= end ? nb : 0;
    i3 -= i3 >= end ? nb : 0;
    const bool h0 = hit(qb, s_box[i0]);
    const bool h1 = hit(qb, s_box[i1]);
    const bool h2 = hit(qb, s_box[i2]);
    const bool h3 = hit(qb, s_box[i3]);
    acc += h0 + h1 + h2 + h3;
  }
  for (; k < nb; ++k) {
    int i = mid + k;
    i -= i >= end ? nb : 0;
    acc += hit(qb, s_box[i]);
  }
  return acc;
}

// What a tile-major pass does with the hits it finds.
enum Mode {
  kPairCount = 0,  // add them to the pair's count, (Q, F)
  kSegCount = 1,   // add them to the (pair, segment) cell, (Q, F, S)
  kEmit = 2,       // write them as (query, tile, slot) at the cell's offset
};

// The arguments of one tile-major pass.
struct Probe {
  const float4* q;       // (Q, 4) query boxes
  const float4* tiles;   // (T, cap, 4) member boxes
  const float4* cboxes;  // (T, C, 4) chunk boxes, or null
  const uint8_t* alive;  // (T, cap) alive flags, or null
  const int32_t* extent; // (T,) live extents, or null
  Groups g;
  int F, cap, C, S;      // S = ceil(cap / kSegSlots)
  bool vec_alive;        // alive rows 16-byte aligned: one load a thread
  int32_t* counts;       // kPairCount: (Q, F); kSegCount and kEmit: (Q, F, S)
  const int64_t* incl;   // kEmit: the inclusive scan of the flat counts
  int64_t* out;          // kEmit: (3, total) int64 query, tile, slot rows
  int64_t total;         // kEmit: hits in all
};

// Emit the hits of query box qb among s_box[beg, end), a warp together:
// 32 boxes an iteration, a ballot and a __popc prefix placing each hit
// after the earlier ones -> the next output position.
__device__ __forceinline__ int64_t emit_range(
    const float4 qb, const float4* s_box, const uint16_t* s_slot, int beg,
    int end, int lane, int base, int64_t query, int t, int64_t cur,
    const Probe& p) {
  for (int i0 = beg; i0 < end; i0 += 32) {
    const int i = i0 + lane;
    const bool h = i < end && hit(qb, s_box[i]);
    const unsigned b = __ballot_sync(0xffffffffu, h);
    if (h) {
      const int64_t pos = cur + __popc(b & ((1u << lane) - 1u));
      p.out[pos] = query;
      p.out[p.total + pos] = t;
      p.out[2 * p.total + pos] = base + s_slot[i];
    }
    cur += __popc(b);
  }
  return cur;
}

// 4. blocks stride over the work items.  An item is (tile, run of up to
//    128 pairs, segment of kSegSlots slots), so no block walks a long
//    tile alone.  The block walks the segment kStep slots at a time.  A
//    thread holds 16 slots' alive flags (one 16-byte load where the row
//    is aligned), so a dead 512-slot stretch costs one warp load; a
//    block scan compacts the alive slots of the step's live chunks, and
//    their boxes are read once into shared memory, coalesced, in slot
//    order.
//    - Counting with chunk boxes, thread i tests the run's i-th query
//      against the step's chunk boxes, and the same scan lists every
//      (query, chunk) the query reaches; threads take the list's entries
//      in turn and count one query against one chunk's boxes each, so a
//      warp never walks a chunk that only some of its queries reach.
//      Hits gather per query in shared memory.
//    - Counting without, every query meets every alive box: a run of n
//      pairs takes parts = 128 / n' threads a pair (n' = n rounded up to
//      a power of two, at least 32), each counting every parts-th box,
//      so short runs still fill the block's warps.
//    - Emitting, warp w takes the run's pairs w, w + 4, ... and walks the
//      boxes of the chunks its query reaches (all of them without chunk
//      boxes) in order; each pair's next output position stays in
//      shared memory from step to step.
//    Counts are added with integer atomics.
template <int MODE, bool SKIP, bool ALIVE>
__global__ void __launch_bounds__(kRun) tile_probe(const Probe p) {
  constexpr bool EMIT = MODE == kEmit;
  constexpr bool LIST = SKIP && !EMIT;  // the (query, chunk) work list
  constexpr bool SHARED_Q = SKIP || EMIT;
  constexpr int kList = LIST ? kStep : 1;
  constexpr int kQueries = SHARED_Q ? kRun : 1;
  constexpr int kPairs = EMIT ? kRun : 1;
  __shared__ float4 s_box[kStep];          // the step's compacted boxes
  __shared__ uint16_t s_slot[kStep];       // their slots, step-relative
  __shared__ uint16_t s_list[kList];       // (query << 4 | chunk) entries
  __shared__ float4 s_q[kQueries];         // the run's query boxes
  __shared__ int s_hits[LIST ? kRun : 1];  // and their hits in this item
  __shared__ int64_t s_cur[kPairs];        // emit: each pair's next position
  __shared__ int32_t s_query[kPairs];      // emit: each pair's query
  __shared__ unsigned s_qlive[SKIP && EMIT ? kRun : 1];  // its live chunks
  __shared__ int s_coff[kStepChunks + 1];  // each chunk's first box
  __shared__ int s_warp[kRun / 32];
  __shared__ unsigned s_live[2][kRun / 32];

  const Groups& g = p.g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items = *g.n_items;
  int step = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int t = g.item_tile[item];
    const int lim = slot_limit(p.extent, t, p.cap);
    const int segs = (lim + kSegSlots - 1) / kSegSlots;
    const int local = item - g.item_off[t];
    const int r = local / segs;
    const int seg = local - r * segs;
    const int seg_begin = seg * kSegSlots;
    const int seg_end = min(seg_begin + kSegSlots, lim);
    const int len = min(kRun, g.hist[t] - r * kRun);
    int span = SHARED_Q ? kRun : 32;  // len rounded up to a power of two
    while (span < len) span <<= 1;
    const int parts = kRun / span, part = tid / span, qi = tid % span;
    const bool valid = qi < len;
    int pair = 0;
    float4 qb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      pair = g.order[g.pair_off[t] + r * kRun + qi];
      qb = p.q[pair / p.F];
    }
    // each thread's own slots, read by others only after a step's barrier
    if (SHARED_Q) s_q[tid] = qb;
    if (LIST) s_hits[tid] = 0;
    if (EMIT && valid) {
      const int64_t cell = static_cast<int64_t>(pair) * p.S + seg;
      s_cur[tid] = p.incl[cell] - p.counts[cell];
      s_query[tid] = pair / p.F;
    }
    const float4* trow = p.tiles + static_cast<int64_t>(t) * p.cap;
    const uint8_t* arow =
        ALIVE ? p.alive + static_cast<int64_t>(t) * p.cap : nullptr;
    const float4* crow =
        SKIP ? p.cboxes + static_cast<int64_t>(t) * p.C : nullptr;

    int acc = 0;
    for (int base = seg_begin; base < seg_end; base += kStep, ++step) {
      const int c0 = base / kChunk;
      const int nc = min(kStepChunks, (seg_end - base + kChunk - 1) / kChunk);
      // bit j of qlive: this query reaches chunk c0 + j; of live: some
      // query of the run does
      unsigned qlive, live;
      if (SKIP) {
        qlive = 0u;
        if (valid) {
#pragma unroll
          for (int j = 0; j < kStepChunks; ++j)  // independent loads
            if (j < nc)
              qlive |= static_cast<unsigned>(hit(qb, crow[c0 + j])) << j;
        }
        if (EMIT) s_qlive[tid] = qlive;
        const unsigned w = __reduce_or_sync(0xffffffffu, qlive);
        unsigned* sl = s_live[step & 1];  // two buffers: a skipped step
        if (lane == 0) sl[warp] = w;      // needs no closing barrier
        __syncthreads();
        live = sl[0] | sl[1] | sl[2] | sl[3];
        if (!live) continue;  // block-uniform
      } else {
        qlive = valid ? 0xffffffffu : 0u;
        live = 0xffffffffu;
      }

      // this thread's 16 slots: their alive flags (0x01 bytes), kept
      // where the chunk is live and the slot below the segment's end
      const int s0 = base + 16 * tid;
      const int n_in = seg_end - s0;
      uint32_t f[4] = {0u, 0u, 0u, 0u};
      if (n_in > 0 && ((live >> (tid >> 3)) & 1u)) {
        if (!ALIVE) {
#pragma unroll
          for (int w = 0; w < 4; ++w) f[w] = low_bytes(n_in - 4 * w);
        } else if (p.vec_alive) {
          const uint4 v = *reinterpret_cast<const uint4*>(arow + s0);
          f[0] = v.x & low_bytes(n_in);
          f[1] = v.y & low_bytes(n_in - 4);
          f[2] = v.z & low_bytes(n_in - 8);
          f[3] = v.w & low_bytes(n_in - 12);
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (4 * w + k < n_in)
                f[w] |= static_cast<uint32_t>(arow[s0 + 4 * w + k] != 0)
                        << (8 * k);
        }
      }
      // one scan places both this thread's alive boxes (low half) and
      // its (query, chunk) entries (high half); each total <= kStep
      const int cnt =
          __popc(f[0]) + __popc(f[1]) + __popc(f[2]) + __popc(f[3]);
      const int ent = LIST ? __popc(qlive) : 0;
      int total;
      const int packed = block_exclusive_scan(cnt | (ent << 16), s_warp,
                                              &total);
      int pos = packed & 0xffff, epos = packed >> 16;
      const int n = total & 0xffff, n_list = total >> 16;
      if ((tid & 7) == 0) s_coff[tid >> 3] = pos;  // 8 threads a chunk
      if (tid == 0) s_coff[kStepChunks] = n;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        for (uint32_t m = f[w]; m; m &= m - 1u)
          s_slot[pos++] = static_cast<uint16_t>(16 * tid + 4 * w +
                                                ((__ffs(m) - 1) >> 3));
      if (LIST)
        for (unsigned m = qlive; m; m &= m - 1u)
          s_list[epos++] = static_cast<uint16_t>((tid << 4) |
                                                 (__ffs(m) - 1));
      __syncthreads();
      for (int i0 = tid; i0 < n; i0 += 4 * kRun) {  // four loads in flight
        float4 b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kRun;
          if (i < n) b[u] = trow[base + s_slot[i]];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kRun;
          if (i < n) s_box[i] = b[u];
        }
      }
      __syncthreads();
      if (EMIT) {
        for (int i = warp; i < len; i += kRun / 32) {  // warp-uniform
          const float4 qq = s_q[i];
          int64_t cur = s_cur[i];
          if (SKIP) {
            for (unsigned m = s_qlive[i]; m; m &= m - 1u) {
              const int j = __ffs(m) - 1;
              cur = emit_range(qq, s_box, s_slot, s_coff[j], s_coff[j + 1],
                               lane, base, s_query[i], t, cur, p);
            }
          } else {
            cur = emit_range(qq, s_box, s_slot, 0, n, lane, base,
                             s_query[i], t, cur, p);
          }
          if (lane == 0) s_cur[i] = cur;
        }
      } else if (LIST) {
        for (int e = tid; e < n_list; e += kRun) {
          const int w = s_list[e], j = w & 15;
          const float4 qq = s_q[w >> 4];
          const int beg = s_coff[j], end = s_coff[j + 1];
          // start each lane at its own box: fewer shared-memory conflicts
          const int mid = beg + (end > beg ? lane % (end - beg) : 0);
          const int h = count_rotated(qq, s_box, beg, mid, end);
          if (h) atomicAdd(&s_hits[w >> 4], h);
        }
      } else if (valid) {
        acc += count_range(qb, s_box, part, n, parts);
      }
      __syncthreads();  // the shared arrays are reused next step
    }
    if (!EMIT) {
      if (LIST) acc = s_hits[tid];
      if (acc)
        atomicAdd(MODE == kSegCount
                      ? p.counts + static_cast<int64_t>(pair) * p.S + seg
                      : p.counts + pair,
                  acc);
    }
  }
}

template <int MODE, bool SKIP, bool ALIVE>
void launch_probe(const Probe& p, int64_t items, cudaStream_t stream) {
  // a persistent grid: as many blocks as the card holds at once, or fewer
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tile_probe<MODE, SKIP, ALIVE>, kRun, 0);
  const int64_t grid = std::max<int64_t>(
      1, std::min<int64_t>(items, static_cast<int64_t>(sms) * per_sm));
  tile_probe<MODE, SKIP, ALIVE>
      <<<static_cast<unsigned>(grid), kRun, 0, stream>>>(p);
}

// One tile-major pass in MODE over the grouping in `scratch`, for the
// chunk-box and alive-mask variant the pointers select.
template <int MODE>
int run_probe(int device, Probe p, long long Q, int T, void* scratch,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = static_cast<int64_t>(Q) * p.F;
  if (pairs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.g = carve(scratch, T, pairs);
  p.vec_alive = p.alive != nullptr && p.cap % 16 == 0 &&
                reinterpret_cast<uintptr_t>(p.alive) % 16 == 0;
  const int64_t items = max_items(T, pairs, p.cap);
  if (p.cboxes != nullptr) {
    if (p.alive != nullptr)
      launch_probe<MODE, true, true>(p, items, s);
    else
      launch_probe<MODE, true, false>(p, items, s);
  } else {
    if (p.alive != nullptr)
      launch_probe<MODE, false, true>(p, items, s);
    else
      launch_probe<MODE, false, false>(p, items, s);
  }
  return static_cast<int>(cudaGetLastError());
}

Probe probe_args(const void* q, const void* tiles, const void* cboxes,
                 const void* alive, const void* extent, int F, int cap,
                 int C, void* counts) {
  Probe p{};
  p.q = static_cast<const float4*>(q);
  p.tiles = static_cast<const float4*>(tiles);
  p.cboxes = static_cast<const float4*>(cboxes);
  p.alive = static_cast<const uint8_t*>(alive);
  p.extent = static_cast<const int32_t*>(extent);
  p.F = F;
  p.cap = cap;
  p.C = C;
  p.S = (cap + kSegSlots - 1) / kSegSlots;
  p.counts = static_cast<int32_t*>(counts);
  return p;
}

}  // namespace

// Launch one routed hit table on `stream` (no synchronisation) and
// return cudaGetLastError().  q (Q, 4) f32; tiles (T, cap, 4) f32;
// cboxes (T, C, 4) f32 or null (no chunk skip); alive (T, cap) bool or
// null; cand (Q, F) int32; out: mask (Q, F, cap) bool.
// C == ceil(cap / 128).
extern "C" int rp_gathered_mask(int device, const void* q, const void* tiles,
                                const void* cboxes, const void* alive,
                                const void* cand, long long Q, int F, int T,
                                int cap, int C, void* mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = static_cast<int64_t>(Q) * F;
  if (pairs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cboxes != nullptr) {
    if (alive != nullptr)
      launch<true, true>(q, tiles, cboxes, alive, cand, pairs, F, T, cap, C,
                         mask, s);
    else
      launch<true, false>(q, tiles, cboxes, alive, cand, pairs, F, T, cap, C,
                          mask, s);
  } else {
    if (alive != nullptr)
      launch<false, true>(q, tiles, cboxes, alive, cand, pairs, F, T, cap, C,
                          mask, s);
    else
      launch<false, false>(q, tiles, cboxes, alive, cand, pairs, F, T, cap, C,
                           mask, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Int32 scratch that rp_group_pairs needs for T tiles of cap slots and
// `pairs` (query, candidate) pairs.
extern "C" long long rp_count_scratch(int T, long long pairs, int cap) {
  return scratch_ints(T, pairs, cap);
}

// Group the live pairs of cand (Q, F) int32 by tile, and their work items
// by tile, run and slot segment, into `scratch` (rp_count_scratch(T,
// Q * F, cap) int32); write 0 to every count of counts (Q, F) int32,
// unless counts is null (the hit lists count elsewhere).  extent (T,)
// int32 or null as for rp_tile_counts.  Launches on `stream`
// (no synchronisation) and returns cudaGetLastError().
extern "C" int rp_group_pairs(int device, const void* cand,
                              const void* extent, long long Q, int F, int T,
                              int cap, void* scratch, void* counts,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = static_cast<int64_t>(Q) * F;
  if (pairs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Groups g = carve(scratch, T, pairs);
  err = cudaMemsetAsync(g.hist, 0, sizeof(int32_t) * static_cast<size_t>(T),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(std::min<int64_t>(
      (pairs + kGroupThreads - 1) / kGroupThreads, kGroupBlocks));
  const int32_t* c = static_cast<const int32_t*>(cand);
  group_rank<<<blocks, kGroupThreads, 0, s>>>(c, pairs, T, g,
                                              static_cast<int32_t*>(counts));
  group_scan<<<1, kScanThreads, 0, s>>>(
      T, static_cast<const int32_t*>(extent), cap, g);
  group_scatter<<<blocks, kGroupThreads, 0, s>>>(c, pairs, g);
  return static_cast<int>(cudaGetLastError());
}

// After rp_group_pairs on the same scratch and extent: the routed counts
// of the live pairs, tile-major, added to counts.  q (Q, 4) f32; tiles
// (T, cap, 4) f32; cboxes (T, C, 4) f32 or null (no chunk skip); alive
// (T, cap) bool or null; extent (T,) int32 or null (always null without
// alive): no slot at or past extent[t] is alive; counts (Q, F) int32.
// C == ceil(cap / 128).
extern "C" int rp_tile_counts(int device, const void* q, const void* tiles,
                              const void* cboxes, const void* alive,
                              const void* extent, long long Q, int F, int T,
                              int cap, int C, void* scratch, void* counts,
                              void* stream) {
  return run_probe<kPairCount>(
      device, probe_args(q, tiles, cboxes, alive, extent, F, cap, C, counts),
      Q, T, scratch, stream);
}

// Slot segments a pair's hits are counted in: ceil(cap / kSegSlots).
extern "C" int rp_hit_segments(int cap) {
  return (cap + kSegSlots - 1) / kSegSlots;
}

// After rp_group_pairs on the same scratch and extent (arguments as for
// rp_tile_counts), one pass of the routed hit list.  emit == 0: add each
// (pair, segment)'s hits to its cell of counts (Q, F, S) int32, zeroed
// by the caller (S = rp_hit_segments(cap)).  emit == 1: with that counts
// array, incl (Q * F * S,) int64 its inclusive scan and total its last
// element, write each hit to out (3, total) int64 as (query, tile, slot)
// rows, in flat (query, candidate, slot) order.  Launches on `stream`
// (no synchronisation) and returns cudaGetLastError().
extern "C" int rp_tile_hits(int device, int emit, const void* q,
                            const void* tiles, const void* cboxes,
                            const void* alive, const void* extent,
                            long long Q, int F, int T, int cap, int C,
                            void* scratch, void* counts, const void* incl,
                            void* out, long long total, void* stream) {
  Probe p = probe_args(q, tiles, cboxes, alive, extent, F, cap, C, counts);
  if (!emit) return run_probe<kSegCount>(device, p, Q, T, scratch, stream);
  if (total == 0) return static_cast<int>(cudaSetDevice(device));
  p.incl = static_cast<const int64_t*>(incl);
  p.out = static_cast<int64_t*>(out);
  p.total = total;
  return run_probe<kEmit>(device, p, Q, T, scratch, stream);
}

// Launch one dense probe on `stream` (no synchronisation) and return
// cudaGetLastError().  q (Q, 4) f32; tiles (T, cap, 4) f32; cboxes
// (T, C, 4) f32 or null (no chunk skip); alive (T, cap) bool or null;
// out: counts (Q, T) int32 when mask_out == 0, else mask (Q, T, cap)
// bool.  C == ceil(cap / 128).
extern "C" int rp_dense_probe(int device, int mask_out, const void* q,
                              const void* tiles, const void* cboxes,
                              const void* alive, long long Q, int T, int cap,
                              int C, void* counts, void* mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool skip = cboxes != nullptr, has_alive = alive != nullptr;
  if (mask_out) {
    if (skip)
      launch_dense_alive<true, true>(has_alive, q, tiles, cboxes, alive, Q, T,
                                     cap, C, counts, mask, s);
    else
      launch_dense_alive<true, false>(has_alive, q, tiles, cboxes, alive, Q,
                                      T, cap, C, counts, mask, s);
  } else {
    if (skip)
      launch_dense_alive<false, true>(has_alive, q, tiles, cboxes, alive, Q,
                                      T, cap, C, counts, mask, s);
    else
      launch_dense_alive<false, false>(has_alive, q, tiles, cboxes, alive, Q,
                                       T, cap, C, counts, mask, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
