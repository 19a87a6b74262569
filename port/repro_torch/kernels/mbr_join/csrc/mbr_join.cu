// Blocked pairwise MBR intersection for NVIDIA Hopper (sm_90a): the
// per-tile spatial-join filter.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/mbr_join/kernel.py:
//   count_pallas (_count_kernel): closed-box hits per (br, bs) block of
//     the (N, M) pair table -> (N/br, M/bs) int32;
//   mask_pallas  (_mask_kernel):  the full (N, M) bool hit table.
// Inputs are component-major (4, N) / (4, M) float32 boxes
// [xmin, ymin, xmax, ymax], padded by the caller to block multiples with
// the inverted sentinel box, which intersects nothing.  The predicate is
//   r.x0 <= s.x1 & s.x0 <= r.x1 & r.y0 <= s.y1 & s.y0 <= r.y1,
// four compares and no arithmetic, so nothing can be contracted and the
// bits equal the plain version's.
//
// count.  The TPU grid walks the (N/br, M/bs) cells in order; Hopper
// runs thread blocks in no order, so each thread block owns whole output
// cells (a grid-stride loop over cells, one cell at a time): it stages
// the cell's bs S boxes in shared memory as float4, each thread tests
// its R row(s) against all of them (a broadcast read per box), and the
// block reduces by warp shuffle and one shared-memory pass.  No atomics:
// the result is exact and repeatable, and one int32 is written per cell.
// Bound on the H100: operations, four compares per pair (N * M of them);
// the inputs (16 B per box, read once) and the output (4 B per cell) are
// small beside them.  Each pair costs one shared-memory load and about
// eight integer and compare instructions.
//
// mask.  Each thread writes VEC (16, 4 or 1, the largest dividing M)
// neighbouring bytes of one row with one store; 8 threads cover 8 * VEC
// columns and a block 32 rows, so a warp writes four rows of 128
// contiguous bytes when VEC = 16.  The block stages its 8 * VEC S boxes
// in shared memory once and walks rows with a grid-stride loop.  Every
// byte of the (N, M) output is written, padding included, so the
// wrapper allocates with torch.empty.  Bound on the H100: bytes, the
// N * M output written once.
//
// The join's path: every live tile of a one-device JoinPlan at once,
// no table.  mask_pallas computes a tile's (N, M) table, which the
// reference then ANDs with reference-point ownership and sums, or takes
// the nonzeros of; one launch here does a whole plan's worth of that.
// Tiles are read as they are staged, (T, cap, 4) float32, a box one
// float4.  Work items are (tile, 512-row block, 1024-column block) over
// each tile's live extent only: a skewed tile spreads over many blocks,
// and padding is never read.  item_start (T + 1, the host's exclusive
// scan of each tile's items) maps an item to its tile by binary search.
// A block stages its item's S boxes in shared memory and each thread
// tests four R rows against each staged box (one shared read, four
// tests).
//   join_rp_counts: per tile, the hits whose reference point
//     (max(r.x0, s.x0), max(r.y0, s.y0)) lies in the tile box,
//     half-open on the high edge and closed where it reaches the
//     universe's, the test made only on hits; each block adds its sum
//     to out[tile] (int64 atomics: exact and order-free).
//   join_row_counts: per live (tile, row), the hits with both ids >= 0
//     (a negative id makes its box NaN, which no compare passes), added
//     to the row's int32 cell.  The wrapper scans the cells, reads the
//     kept total once, and
//   join_emit_rows writes (r_id, s_id) with the same tests, a block per
//     (tile, 512-row block) walking the tile's S boxes through shared
//     memory, a thread per row writing its hits in s order at the row's
//     place, so a tile's pairs come out row-major with s ascending, at
//     the tile's offset, its first max_pairs kept; a row stops once its
//     kept pairs are out, the block once all its rows have.
// Bound on the H100: operations, four compares per live (r, s) test, at
// 67 T/s; the pair list adds 8 B a pair written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColThreads = 8;    // mask: threads across columns
constexpr int kRowThreads = 32;   // mask: rows per block

__device__ __forceinline__ bool hit(float x0, float y0, float x1, float y1,
                                    const float4& s) {
  return (x0 <= s.z) & (s.x <= x1) & (y0 <= s.w) & (s.y <= y1);
}

__global__ void count_kernel(const float* __restrict__ r4,
                             const float* __restrict__ s4, long long n,
                             long long m, int br, int bs,
                             long long ncol, long long cells,
                             int* __restrict__ out) {
  extern __shared__ float4 sbox[];
  __shared__ int wsum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (long long cell = blockIdx.x; cell < cells; cell += gridDim.x) {
    const long long bi = cell / ncol, bj = cell - bi * ncol;
    __syncthreads();                  // the previous cell is done with sbox
    for (int j = threadIdx.x; j < bs; j += blockDim.x) {
      const long long c = bj * bs + j;
      sbox[j] = make_float4(s4[c], s4[m + c], s4[2 * m + c], s4[3 * m + c]);
    }
    __syncthreads();
    int cnt = 0;
    for (int r = threadIdx.x; r < br; r += blockDim.x) {
      const long long row = bi * br + r;
      const float x0 = r4[row], y0 = r4[n + row];
      const float x1 = r4[2 * n + row], y1 = r4[3 * n + row];
#pragma unroll 8
      for (int j = 0; j < bs; ++j) cnt += hit(x0, y0, x1, y1, sbox[j]);
    }
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    if (lane == 0) wsum[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
      int v = lane < nwarps ? wsum[lane] : 0;
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) out[cell] = v;
    }
  }
}

template <int VEC>
__global__ void mask_kernel(const float* __restrict__ r4,
                            const float* __restrict__ s4, long long n,
                            long long m, uint8_t* __restrict__ out) {
  __shared__ float4 sbox[kColThreads * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long col0 = static_cast<long long>(blockIdx.x) * kColThreads * VEC;
  for (int j = ty * kColThreads + tx; j < kColThreads * VEC;
       j += kColThreads * kRowThreads) {
    const long long c = col0 + j;
    sbox[j] = c < m ? make_float4(s4[c], s4[m + c], s4[2 * m + c],
                                  s4[3 * m + c])
                    : make_float4(9e9f, 9e9f, -9e9f, -9e9f);
  }
  __syncthreads();
  const long long c = col0 + static_cast<long long>(tx) * VEC;
  if (c >= m) return;                 // M % VEC == 0: a vector is all in
  const float4* sb = sbox + tx * VEC;
  for (long long row = static_cast<long long>(blockIdx.y) * kRowThreads + ty;
       row < n; row += static_cast<long long>(gridDim.y) * kRowThreads) {
    const float x0 = r4[row], y0 = r4[n + row];
    const float x1 = r4[2 * n + row], y1 = r4[3 * n + row];
    uint8_t* dst = out + row * m + c;
    if constexpr (VEC == 16) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        w[k >> 2] |= static_cast<uint32_t>(hit(x0, y0, x1, y1, sb[k]))
                     << (8 * (k & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC == 4) {
      uint32_t w = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w |= static_cast<uint32_t>(hit(x0, y0, x1, y1, sb[k])) << (8 * k);
      *reinterpret_cast<uint32_t*>(dst) = w;
    } else {
      *dst = static_cast<uint8_t>(hit(x0, y0, x1, y1, sb[0]));
    }
  }
}

template <int VEC>
void launch_mask(const float* r4, const float* s4, long long n, long long m,
                 uint8_t* out, cudaStream_t stream) {
  const long long cols = kColThreads * VEC;
  const long long gx = (m + cols - 1) / cols;
  long long gy = (n + kRowThreads - 1) / kRowThreads;
  if (gy > 65535) gy = 65535;         // rows beyond: grid-stride
  mask_kernel<VEC><<<dim3(static_cast<unsigned>(gx),
                          static_cast<unsigned>(gy)),
                     dim3(kColThreads, kRowThreads), 0, stream>>>(
      r4, s4, n, m, out);
}


// ---------------------------------------------------------------------
// The join's path: every live tile of a plan at once
// ---------------------------------------------------------------------

constexpr int kItemThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kItemRows = kItemThreads * kRowsPerThread;   // 512
constexpr int kItemCols = 1024;                            // 16 KB staged

enum ItemMode { kRpCount = 0, kRowCount = 1 };

__device__ __forceinline__ float4 nan_box() {
  const float n = __int_as_float(0x7fffffff);
  return make_float4(n, n, n, n);
}

// acc += hit(r, s): four chained compares into one predicate and one
// predicated add.
__device__ __forceinline__ void add_hit(int& acc, const float4& r,
                                        const float4& s) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f32 p, %1, %2;\n\t"
      "setp.le.and.f32 p, %3, %4, p;\n\t"
      "setp.le.and.f32 p, %5, %6, p;\n\t"
      "setp.le.and.f32 p, %7, %8, p;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(acc)
      : "f"(r.x), "f"(s.z), "f"(s.x), "f"(r.z), "f"(r.y), "f"(s.w),
        "f"(s.y), "f"(r.w));
}

// Reference-point ownership of a hit, as query/join.py rp_own_mask.
__device__ __forceinline__ bool owned(const float4& r, const float4& s,
                                      const float4& tb, bool closed_x,
                                      bool closed_y) {
  const float px = fmaxf(r.x, s.x), py = fmaxf(r.y, s.y);
  const bool hx = closed_x ? px <= tb.z : px < tb.z;
  const bool hy = closed_y ? py <= tb.w : py < tb.w;
  return (px >= tb.x) & hx & (py >= tb.y) & hy;
}

// The tile of a flat index: the last t with start[t] <= i, over t in
// [0, tiles).
__device__ __forceinline__ int tile_of(const long long* start, int tiles,
                                       long long i) {
  int lo = 0, hi = tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct TileArgs {
  const float4* r_tiles;   // (T, cap_r)
  const float4* s_tiles;   // (T, cap_s)
  const int* r_ids;        // (T, cap_r), kRowCount and emit only
  const int* s_ids;        // (T, cap_s)
  const float4* tile_boxes;
  const float* uni;
  const long long* live_r;     // (T,)
  const long long* live_s;     // (T,)
  const long long* item_start; // (T + 1,)
  const long long* row_base;   // (T + 1,): a tile's first live-row cell
  long long cap_r, cap_s, items;
  int tiles;
};

template <int MODE>
__global__ void __launch_bounds__(kItemThreads)
join_items(TileArgs a, long long* __restrict__ tile_out,
           int* __restrict__ row_out) {
  __shared__ float4 sbox[kItemCols];
  __shared__ int wsum[kItemThreads / 32];
  const int tid = threadIdx.x;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int t = tile_of(a.item_start, a.tiles, item);
    const long long lr = a.live_r[t], ls = a.live_s[t];
    const long long ncb = (ls + kItemCols - 1) / kItemCols;
    const long long local = item - a.item_start[t];
    const long long r0 = (local / ncb) * kItemRows;
    const long long c0 = (local % ncb) * kItemCols;
    const int ns = static_cast<int>(ls - c0 < kItemCols ? ls - c0 : kItemCols);
    __syncthreads();                  // the previous item is done with sbox
    const float4* sb = a.s_tiles + t * a.cap_s + c0;
    for (int j = tid; j < ns; j += kItemThreads) {
      float4 v = sb[j];
      if (MODE == kRowCount && a.s_ids[t * a.cap_s + c0 + j] < 0)
        v = nan_box();
      sbox[j] = v;
    }
    __syncthreads();
    float4 rb[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long r = r0 + tid + k * kItemThreads;
      rb[k] = nan_box();
      if (r < lr && (MODE != kRowCount || a.r_ids[t * a.cap_r + r] >= 0))
        rb[k] = a.r_tiles[t * a.cap_r + r];
    }
    if (MODE == kRpCount) {
      const float4 tb = a.tile_boxes[t];
      const bool cx = tb.z >= a.uni[2], cy = tb.w >= a.uni[3];
      int acc = 0;
      for (int j = 0; j < ns; ++j) {
        const float4 s = sbox[j];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k)
          if (hit(rb[k].x, rb[k].y, rb[k].z, rb[k].w, s))
            acc += owned(rb[k], s, tb, cx, cy);
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if ((tid & 31) == 0) wsum[tid >> 5] = acc;
      __syncthreads();
      if (tid == 0) {
        int sum = 0;
#pragma unroll
        for (int w = 0; w < kItemThreads / 32; ++w) sum += wsum[w];
        if (sum)
          atomicAdd(reinterpret_cast<unsigned long long*>(tile_out + t),
                    static_cast<unsigned long long>(sum));
      }
    } else {
      int acc[kRowsPerThread] = {};
      int j = 0;
      for (; j + 3 < ns; j += 4) {
        float4 s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = sbox[j + u];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < kRowsPerThread; ++k) add_hit(acc[k], rb[k], s[u]);
      }
      for (; j < ns; ++j) {
        const float4 s = sbox[j];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) add_hit(acc[k], rb[k], s);
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k)
        if (acc[k])
          atomicAdd(row_out + a.row_base[t] + r0 + tid + k * kItemThreads,
                    acc[k]);
    }
  }
}

// (r_id, s_id) of every counted hit.  A block takes the items of
// column block 0, so one (tile, 512-row block) each, and walks the
// tile's S boxes 1,024 at a time through shared memory as the count
// pass does; each thread writes its four rows' pairs in s order at their
// places (excl (rows + 1) is the exclusive scan of the row cells,
// out_start (T) each tile's first output slot) and leaves a row once its
// kept pairs are out; the block leaves the tile when all its rows have.
__global__ void __launch_bounds__(kItemThreads)
join_emit_rows(TileArgs a, const int* __restrict__ row_cells,
               const long long* __restrict__ excl,
               const long long* __restrict__ out_start, long long max_pairs,
               int* __restrict__ out_r, int* __restrict__ out_s) {
  __shared__ float4 sbox[kItemCols];
  __shared__ int sid[kItemCols];
  const int tid = threadIdx.x;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int t = tile_of(a.item_start, a.tiles, item);
    const long long lr = a.live_r[t], ls = a.live_s[t];
    const long long ncb = (ls + kItemCols - 1) / kItemCols;
    const long long local = item - a.item_start[t];
    if (local % ncb) continue;              // one block per row block
    const long long r0 = (local / ncb) * kItemRows;
    const long long base = a.row_base[t], first = excl[base];
    float4 rb[kRowsPerThread];
    int rid[kRowsPerThread], room[kRowsPerThread], done[kRowsPerThread];
    long long pos[kRowsPerThread];
    int left = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long r = r0 + tid + k * kItemThreads;
      rb[k] = nan_box();
      room[k] = done[k] = 0;
      rid[k] = -1;
      pos[k] = 0;
      if (r < lr) {
        const long long within = excl[base + r] - first;
        const long long cap = max_pairs - within;
        const int cnt = row_cells[base + r];
        room[k] = cap <= 0 ? 0 : (cap < cnt ? static_cast<int>(cap) : cnt);
        if (room[k]) {
          rb[k] = a.r_tiles[t * a.cap_r + r];
          rid[k] = a.r_ids[t * a.cap_r + r];
          pos[k] = out_start[t] + within;
          ++left;
        }
      }
    }
    for (long long c0 = 0; c0 < ls; c0 += kItemCols) {
      if (!__syncthreads_or(left)) break;   // also: the last step is done
      const int ns =
          static_cast<int>(ls - c0 < kItemCols ? ls - c0 : kItemCols);
      for (int j = tid; j < ns; j += kItemThreads) {
        const int id = a.s_ids[t * a.cap_s + c0 + j];
        sbox[j] = id >= 0 ? a.s_tiles[t * a.cap_s + c0 + j] : nan_box();
        sid[j] = id;
      }
      __syncthreads();
      for (int j = 0; j < ns; ++j) {
        const float4 s = sbox[j];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          if (hit(rb[k].x, rb[k].y, rb[k].z, rb[k].w, s)) {
            out_r[pos[k] + done[k]] = rid[k];
            out_s[pos[k] + done[k]] = sid[j];
            if (++done[k] == room[k]) {     // the row's kept pairs are out
              rb[k] = nan_box();
              --left;
            }
          }
        }
      }
    }
    __syncthreads();                        // before the next item's staging
  }
}

int item_grid(long long items, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long cap = 16LL * sms;
  return static_cast<int>(items < cap ? items : cap);
}

TileArgs tile_args(const void* r_tiles, const void* s_tiles,
                   const void* r_ids, const void* s_ids,
                   const void* tile_boxes, const void* uni, const void* meta,
                   long long cap_r, long long cap_s, int tiles,
                   long long items) {
  const long long* m = static_cast<const long long*>(meta);
  return TileArgs{static_cast<const float4*>(r_tiles),
                  static_cast<const float4*>(s_tiles),
                  static_cast<const int*>(r_ids),
                  static_cast<const int*>(s_ids),
                  static_cast<const float4*>(tile_boxes),
                  static_cast<const float*>(uni),
                  m, m + tiles, m + 2 * tiles, m + 3 * tiles + 1,
                  cap_r, cap_s, items, tiles};
}

}  // namespace

// r4 (4, N) f32, s4 (4, M) f32, N % br == 0, M % bs == 0, bs <= 2048;
// out (N/br, M/bs) int32.  Returns cudaGetLastError().
extern "C" int mbr_join_count(int device, const void* r4, const void* s4,
                              long long n, long long m, int br, int bs,
                              void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ncol = m / bs;
  const long long cells = (n / br) * ncol;
  int threads = ((br + 31) / 32) * 32;
  if (threads > 256) threads = 256;   // more rows: loop per thread
  long long blocks = cells < 132LL * 16 ? cells : 132LL * 16;
  count_kernel<<<static_cast<unsigned>(blocks), threads,
                 bs * sizeof(float4), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r4), static_cast<const float*>(s4), n, m, br,
      bs, ncol, cells, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// r4 (4, N) f32, s4 (4, M) f32; out (N, M) bool.  Returns
// cudaGetLastError().
extern "C" int mbr_join_mask(int device, const void* r4, const void* s4,
                             long long n, long long m, void* out,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* r = static_cast<const float*>(r4);
  const float* s = static_cast<const float*>(s4);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m % 16 == 0) {
    launch_mask<16>(r, s, n, m, o, st);
  } else if (m % 4 == 0) {
    launch_mask<4>(r, s, n, m, o, st);
  } else {
    launch_mask<1>(r, s, n, m, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The join's batched passes over a one-device plan's T tiles: r_tiles
// (T, cap_r, 4) and s_tiles (T, cap_s, 4) float32, r_ids / s_ids int32
// (T, cap), tile_boxes (T, 4), uni (4,), meta int64 [live_r (T), live_s
// (T), item_start (T + 1), row_base (T + 1)], every pointer 16-byte
// aligned.  mode 0 adds each tile's rp-owned hits to tile_out (T) int64
// (zeroed by the caller); mode 1 adds each live row's hits with both ids
// >= 0 to row_out (row_base[T]) int32 (zeroed).  Returns
// cudaGetLastError().
extern "C" int mbr_join_tiles(int device, int mode, const void* r_tiles,
                              const void* s_tiles, const void* r_ids,
                              const void* s_ids, const void* tile_boxes,
                              const void* uni, const void* meta,
                              long long cap_r, long long cap_s, int tiles,
                              long long items, void* tile_out,
                              void* row_out, void* stream) {
  if ((mode != kRpCount && mode != kRowCount) || tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (items == 0) return 0;
  const TileArgs a = tile_args(r_tiles, s_tiles, r_ids, s_ids, tile_boxes,
                               uni, meta, cap_r, cap_s, tiles, items);
  const int grid = item_grid(items, device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kRpCount)
    join_items<kRpCount><<<grid, kItemThreads, 0, st>>>(
        a, static_cast<long long*>(tile_out), nullptr);
  else
    join_items<kRowCount><<<grid, kItemThreads, 0, st>>>(
        a, nullptr, static_cast<int*>(row_out));
  return static_cast<int>(cudaGetLastError());
}

// The pair list's emit pass after mbr_join_tiles mode 1, over the same
// items: row_cells (rows) int32, excl (rows + 1) int64 their exclusive
// scan, out_start (T) int64; writes out_r / out_s int32 (the kept total
// each).
extern "C" int mbr_join_emit(int device, const void* r_tiles,
                             const void* s_tiles, const void* r_ids,
                             const void* s_ids, const void* meta,
                             long long cap_r, long long cap_s, int tiles,
                             long long items, const void* row_cells,
                             const void* excl, const void* out_start,
                             long long max_pairs, void* out_r, void* out_s,
                             void* stream) {
  if (tiles < 1 || max_pairs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (items == 0 || max_pairs == 0) return 0;
  const TileArgs a = tile_args(r_tiles, s_tiles, r_ids, s_ids, nullptr,
                               nullptr, meta, cap_r, cap_s, tiles, items);
  join_emit_rows<<<item_grid(items, device), kItemThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(row_cells),
      static_cast<const long long*>(excl),
      static_cast<const long long*>(out_start), max_pairs,
      static_cast<int*>(out_r), static_cast<int*>(out_s));
  return static_cast<int>(cudaGetLastError());
}

// Geometry of the batched passes' work items, for the host's scan.
extern "C" int mbr_join_item_shape(int* rows, int* cols) {
  *rows = kItemRows;
  *cols = kItemCols;
  return 0;
}

extern "C" const char* mbr_join_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
