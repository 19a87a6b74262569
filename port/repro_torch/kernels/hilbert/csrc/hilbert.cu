// Hilbert-curve xy->d encode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel encode_pallas (_hilbert_kernel) of
// src/repro/kernels/hilbert/kernel.py: the classic iterative transform,
// one bit plane per step, over uint32 grid coordinates.  The TPU kernel
// takes (R, 128) blocks, a layout of the TPU's lanes; here one thread
// owns one point of a flat (N,) array and the grid masks the ragged
// edge, so the wrapper pads nothing.
//
// Arithmetic: native uint32, so the reference's wraparound in
// s - 1 - x (and in s * s for orders above 16) comes for free.  The
// inputs are int32 grids (values in [0, 2^order)); the output is the
// uint32 key widened to int64, so that a torch sort orders keys as
// unsigned.
//
// Bound on the H100: operations.  A point reads 8 bytes and writes 8,
// and costs about 21 integer operations per bit plane (336 at order
// 16), so at 16 bytes a point the 3.35 TB/s memory moves points far
// faster than the integer pipes can encode them.  The design keeps the
// loop in registers with no shared memory and no divergence beyond two
// selects per step, and reads and writes coalesced (neighbouring
// threads, neighbouring points); a grid-stride loop covers any N.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void encode_kernel(const int32_t* __restrict__ gx,
                              const int32_t* __restrict__ gy,
                              int64_t* __restrict__ out, long long n,
                              int order) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    uint32_t x = static_cast<uint32_t>(gx[i]);
    uint32_t y = static_cast<uint32_t>(gy[i]);
    uint32_t d = 0u;
    for (int b = order - 1; b >= 0; --b) {
      const uint32_t s = 1u << b;
      const uint32_t rx = (x & s) > 0u ? 1u : 0u;
      const uint32_t ry = (y & s) > 0u ? 1u : 0u;
      d += s * s * ((3u * rx) ^ ry);
      if (ry == 0u) {                 // rotate the quadrant
        if (rx == 1u) {
          x = s - 1u - x;
          y = s - 1u - y;
        }
        const uint32_t t = x;
        x = y;
        y = t;
      }
    }
    out[i] = static_cast<int64_t>(d);
  }
}

}  // namespace

// gx, gy (N,) int32; out (N,) int64.  Returns cudaGetLastError().
extern "C" int hilbert_encode(int device, const void* gx, const void* gy,
                              void* out, long long n, int order,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
  encode_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gx), static_cast<const int32_t*>(gy),
      static_cast<int64_t*>(out), n, order);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hilbert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
