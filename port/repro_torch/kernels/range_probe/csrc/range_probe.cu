// Routed range probe for NVIDIA Hopper (sm_90a).
//
// Replaces the four gathered Pallas TPU kernels of
// src/repro/kernels/range_probe/kernel.py, each with its alive variant:
//   gather_count_pallas       (_gather_count_kernel, _gather_count_alive_kernel)
//   gather_mask_pallas        (_gather_mask_kernel, _gather_mask_alive_kernel)
//   gather_count_skip_pallas  (_gather_count_skip_kernel, ..._alive_kernel)
//   gather_mask_skip_pallas   (_gather_mask_skip_kernel, ..._alive_kernel)
// One templated kernel, instantiated for count/mask x skip/no-skip x
// alive/none, computes what repro/kernels/range_probe/ref.py computes
// (gathered_counts, gathered_mask and their chunk-masked *_skip twins).
//
// What differs from the TPU kernels:
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

extern "C" const char* rp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
