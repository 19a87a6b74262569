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

extern "C" const char* mbr_join_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
