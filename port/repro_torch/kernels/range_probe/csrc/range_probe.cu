// Range probe for NVIDIA Hopper (sm_90a): routed (gathered) and dense.
//
// Replaces the eight Pallas TPU kernels of
// src/repro/kernels/range_probe/kernel.py, each with its alive variant.
// Gathered (routed) entry points, rp_gathered_probe:
//   gather_count_pallas       (_gather_count_kernel, _gather_count_alive_kernel)
//   gather_mask_pallas        (_gather_mask_kernel, _gather_mask_alive_kernel)
//   gather_count_skip_pallas  (_gather_count_skip_kernel, ..._alive_kernel)
//   gather_mask_skip_pallas   (_gather_mask_skip_kernel, ..._alive_kernel)
// Dense (all-tile) entry points, rp_dense_probe:
//   count_pallas              (_count_kernel, _count_alive_kernel)
//   mask_pallas               (_mask_kernel, _mask_alive_kernel)
//   count_skip_pallas         (_count_skip_kernel, _count_skip_alive_kernel)
//   mask_skip_pallas          (_mask_skip_kernel, _mask_skip_alive_kernel)
// Two templated kernels, instantiated for count/mask x skip/no-skip x
// alive/none, compute what repro/kernels/range_probe/ref.py computes
// (gathered_* and probe_* with their chunk-masked *_skip twins).
//
// Gathered design, and what differs from the TPU kernels:
// - No gathered stack.  The TPU path materialises (Q, F, 4, cap) member
//   boxes before the call; here each warp reads cand[q, f] itself and
//   indexes the row-major (T, cap, 4) canonical tiles directly, one
//   float4 per slot.  A candidate outside [0, T) (the -1 padding) gives
//   zero hits and an all-false mask row, as the reference's appended
//   sentinel row does.  Queries are not padded; cap need not be a
//   multiple of 128: the ragged last chunk is masked.
// - Skip per query.  Pallas skips a chunk only when no query of its
//   128-query block hits the chunk box.  Here one warp owns one
//   (query, candidate) pair: lane c tests chunk box c, a ballot gives
//   the warp-uniform set of live chunks, and only those chunks' member
//   boxes are read.  Per-query predication is what the chunk-masked ref
//   oracles define, so the bits equal ref even for chunk boxes that do
//   not bound their members.
// - With an alive mask, a lane reads a slot's box only when the slot is
//   alive, so dead and non-canonical slots cost one byte, not sixteen.
//
// Bound on the H100: bytes.  A pair reads 16 B per member box and 1 B
// per alive flag in each live chunk, 16 B per chunk box, and writes 4 B
// (count) or cap bytes (mask), with no arithmetic worth counting (four
// float compares per slot).  The design keeps every read coalesced
// (32 lanes x 16 B contiguous per load) and skips the reads that the
// chunk test or the alive flag make unnecessary; it does not yet share
// a tile between the warps of queries that probe the same candidate.
// Outputs are written in full, skipped chunks included, so the wrapper
// allocates them with torch.empty.
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

namespace {

constexpr int kChunk = 128;
constexpr int kWarps = 8;  // (query, candidate) pairs per block

__device__ __forceinline__ bool hit(const float4 q, const float4 s) {
  return (q.x <= s.z) & (s.x <= q.z) & (q.y <= s.w) & (s.y <= q.w);
}

template <bool MASK, bool SKIP, bool ALIVE>
__global__ void __launch_bounds__(kWarps * 32)
gathered_probe(const float4* __restrict__ q, const float4* __restrict__ tiles,
               const float4* __restrict__ cboxes,
               const uint8_t* __restrict__ alive,
               const int32_t* __restrict__ cand, int64_t pairs, int F, int T,
               int cap, int C, int32_t* __restrict__ counts,
               uint8_t* __restrict__ mask) {
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (pair >= pairs) return;  // warp-uniform: a warp owns one pair
  const int t = cand[pair];
  const float4 qb = q[pair / F];
  uint8_t* mrow = MASK ? mask + pair * cap : nullptr;

  if (t < 0 || t >= T) {  // padding candidate: no hits
    if (MASK) {
      for (int s = lane; s < cap; s += 32) mrow[s] = 0;
    } else if (lane == 0) {
      counts[pair] = 0;
    }
    return;
  }
  const float4* trow = tiles + static_cast<int64_t>(t) * cap;
  const uint8_t* arow = ALIVE ? alive + static_cast<int64_t>(t) * cap : nullptr;
  const float4* crow = SKIP ? cboxes + static_cast<int64_t>(t) * C : nullptr;

  int acc = 0;
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
      if (!on && !MASK) continue;
#pragma unroll
      for (int j = 0; j < kChunk / 32; ++j) {
        const int s = base + j * 32 + lane;
        if (s < cap) {
          bool h = false;
          if (on && (!ALIVE || arow[s])) h = hit(qb, trow[s]);
          if (MASK) mrow[s] = h;
          acc += h;
        }
      }
    }
  }
  if (!MASK) {
    acc = __reduce_add_sync(0xffffffffu, acc);
    if (lane == 0) counts[pair] = acc;
  }
}

template <bool MASK, bool SKIP, bool ALIVE>
void launch(const void* q, const void* tiles, const void* cboxes,
            const void* alive, const void* cand, int64_t pairs, int F, int T,
            int cap, int C, void* counts, void* mask, cudaStream_t stream) {
  const int64_t blocks = (pairs + kWarps - 1) / kWarps;
  gathered_probe<MASK, SKIP, ALIVE><<<static_cast<unsigned>(blocks),
                                      kWarps * 32, 0, stream>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(tiles),
      static_cast<const float4*>(cboxes), static_cast<const uint8_t*>(alive),
      static_cast<const int32_t*>(cand), pairs, F, T, cap, C,
      static_cast<int32_t*>(counts), static_cast<uint8_t*>(mask));
}

template <bool MASK, bool SKIP>
void launch_alive(bool has_alive, const void* q, const void* tiles,
                  const void* cboxes, const void* alive, const void* cand,
                  int64_t pairs, int F, int T, int cap, int C, void* counts,
                  void* mask, cudaStream_t stream) {
  if (has_alive)
    launch<MASK, SKIP, true>(q, tiles, cboxes, alive, cand, pairs, F, T, cap,
                             C, counts, mask, stream);
  else
    launch<MASK, SKIP, false>(q, tiles, cboxes, alive, cand, pairs, F, T, cap,
                              C, counts, mask, stream);
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

}  // namespace

// Launch one routed probe on `stream` (no synchronisation) and return
// cudaGetLastError().  q (Q, 4) f32; tiles (T, cap, 4) f32; cboxes
// (T, C, 4) f32 or null (no chunk skip); alive (T, cap) bool or null;
// cand (Q, F) int32; out: counts (Q, F) int32 when mask_out == 0, else
// mask (Q, F, cap) bool.  C == ceil(cap / 128).
extern "C" int rp_gathered_probe(int device, int mask_out, const void* q,
                                 const void* tiles, const void* cboxes,
                                 const void* alive, const void* cand,
                                 long long Q, int F, int T, int cap, int C,
                                 void* counts, void* mask, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = static_cast<int64_t>(Q) * F;
  if (pairs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool skip = cboxes != nullptr, has_alive = alive != nullptr;
  if (mask_out) {
    if (skip)
      launch_alive<true, true>(has_alive, q, tiles, cboxes, alive, cand,
                               pairs, F, T, cap, C, counts, mask, s);
    else
      launch_alive<true, false>(has_alive, q, tiles, cboxes, alive, cand,
                                pairs, F, T, cap, C, counts, mask, s);
  } else {
    if (skip)
      launch_alive<false, true>(has_alive, q, tiles, cboxes, alive, cand,
                                pairs, F, T, cap, C, counts, mask, s);
    else
      launch_alive<false, false>(has_alive, q, tiles, cboxes, alive, cand,
                                 pairs, F, T, cap, C, counts, mask, s);
  }
  return static_cast<int>(cudaGetLastError());
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
