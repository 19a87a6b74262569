// Hilbert-curve xy->d encode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel encode_pallas (_hilbert_kernel) of
// src/repro/kernels/hilbert/kernel.py.  The TPU kernel runs the classic
// iterative transform, one bit plane per step, on (R, 128) blocks (a
// layout of the TPU's lanes); here the grid walks a flat (N,) array and
// masks its ragged edge, so the wrapper pads nothing.  Inputs are int32
// grids (values in [0, 2^order)); the output is the uint32 key widened
// to int64, so that a torch sort orders keys as unsigned.
//
// Bound on the H100: bytes.  A point reads 8 bytes and writes 8 (4.8 ps
// a point at 3.35 TB/s); the classic loop costs about 21 integer
// operations a plane, 336 at order 16, which made the first design (the
// plane loop, encode_v1 below) bound by operations.  Orders 1-16
// therefore take all planes at once, in 63 instructions a point (the
// vector loop's SASS: 252 for four points; 1.9 ps at 33.5 T/s):
//
// The classic step at plane b reads the current bits (rx, ry) of the
// transformed coordinates, adds the digit (3 rx) ^ ry, and if ry == 0
// swaps x and y, complementing both first if rx == 1.  The transform
// the planes above b have applied is swap^sigma . complement^kappa
// (the two commute), so with raw bits (xb, yb) and a = xb ^ yb:
//   rx = (sigma ? yb : xb) ^ kappa,   ry = rx ^ a,
//   digit = 2 h + a  with  h = rx = xb ^ (sigma & a) ^ kappa.
// Only h needs the state (sigma, kappa) entering the plane.  The step
// on the state is, case by case (a = 0: the digit is 0 or 2 and the
// step swaps iff xb == kappa; a = 1: it swaps and complements iff
// rx == 1):
//   a = 0:  sigma' = sigma ^ kappa ^ !xb,  kappa' = kappa;
//   a = 1:  sigma' = kappa ^ xb,           kappa' = sigma ^ xb.
// Read the state as z = sigma + kappa w in GF(4) (w^2 = w + 1, + is
// xor).  Then squaring is z^2 = (sigma ^ kappa) + kappa w, and w z^2 =
// kappa + sigma w, so every plane's step is F(z) = m z^2 + k with
//   m = 1 (a = 0) or w (a = 1),   k = !yb + (a & xb) w.
// Two such maps compose to m2 m1^2 z^4 + (m2 k1^2 + k2) and z^4 = z:
// an affine map of GF(4) (the group A4); affine maps compose as (M2 M1,
// M2 K1 + K2).  So an inclusive scan over the planes, from the top
// plane down, with the square applied once in its first round (a lone
// plane is the later map only there: every later round joins windows
// of even length), gives each plane's composite map; applied to the
// initial state 0 it is its K.  The state entering plane b is K of
// plane b + 1.  The scan is four rounds of shifts over bit-plane words
// (a GF(4) product is four ands and three xors on two words), planes
// above the order are the constant map 0 (m = k = 0: shifts bring in
// zeros), and a word holds two points (planes 0-15 and 16-31), so each
// round clears what crosses from the high point into the low one.
// Finally the key's odd bits are h and its even bits a: two byte
// permutes and three delta swaps interleave them.
// tests/test_torch_hilbert.py models this arithmetic word for word and
// holds it to the reference's keys.
//
// Memory: four points a thread, gx and gy read as int4 and the keys
// written as two 16-byte stores, over a grid-stride loop sized to the
// SMs, and a scalar tail for N % 4.  The vector loads need every
// pointer 16-byte aligned (a slice's storage offset need not be): the
// entry takes the scalar path otherwise.  Orders 17-31 keep the loop:
// their reference keys wrap in uint32 (s * s), which the scan does not
// model.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// The first design: one thread a point, one plane a step (encode_v1,
// and every order above 16).
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t encode_loop(uint32_t x, uint32_t y,
                                                int order) {
  uint32_t d = 0u;
  for (int b = order - 1; b >= 0; --b) {
    const uint32_t s = 1u << b;
    const uint32_t rx = (x & s) > 0u ? 1u : 0u;
    const uint32_t ry = (y & s) > 0u ? 1u : 0u;
    d += s * s * ((3u * rx) ^ ry);
    if (ry == 0u) {                   // rotate the quadrant
      if (rx == 1u) {
        x = s - 1u - x;
        y = s - 1u - y;
      }
      const uint32_t t = x;
      x = y;
      y = t;
    }
  }
  return d;
}

__global__ void encode_loop_kernel(const int32_t* __restrict__ gx,
                                   const int32_t* __restrict__ gy,
                                   int64_t* __restrict__ out, long long n,
                                   int order) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = static_cast<int64_t>(encode_loop(
        static_cast<uint32_t>(gx[i]), static_cast<uint32_t>(gy[i]), order));
}

// ---------------------------------------------------------------------
// Orders 1-16: every plane at once, two points a word
// ---------------------------------------------------------------------

// c = a * b in GF(4), bitwise over the planes of a word.
__device__ __forceinline__ void gf4_mul(uint32_t a0, uint32_t a1,
                                        uint32_t b0, uint32_t b1,
                                        uint32_t& c0, uint32_t& c1) {
  c0 = (a0 & b0) ^ (a1 & b1);
  c1 = (a0 & b1) ^ (a1 & (b0 ^ b1));
}

// Interleave a word whose bytes are (a0, h0, a1, h1), low byte first:
// bit 2i <- a bit i, bit 2i + 1 <- h bit i.
__device__ __forceinline__ uint32_t interleave(uint32_t w) {
  uint32_t t = (w ^ (w >> 4)) & 0x00F000F0u;
  w ^= t ^ (t << 4);
  t = (w ^ (w >> 2)) & 0x0C0C0C0Cu;
  w ^= t ^ (t << 2);
  t = (w ^ (w >> 1)) & 0x22222222u;
  return w ^ t ^ (t << 1);
}

// The keys of two points (x0, y0) and (x1, y1); lo_mask holds the
// order's planes in each half.
__device__ __forceinline__ void encode_two(uint32_t x0, uint32_t x1,
                                           uint32_t y0, uint32_t y1,
                                           uint32_t lo_mask, uint32_t& d0,
                                           uint32_t& d1) {
  const uint32_t x = __byte_perm(x0, x1, 0x5410) & lo_mask;
  const uint32_t y = __byte_perm(y0, y1, 0x5410) & lo_mask;
  const uint32_t a = x ^ y;
  uint32_t m0 = ~a & lo_mask, m1 = a;          // m = 1 or w
  uint32_t k0 = ~y & lo_mask, k1 = a & x;      // k = !yb + (a & xb) w
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = 1 << r;
    // the low point's top s planes would read the high point's
    const uint32_t keep = ~(((1u << s) - 1u) << (16 - s));
    const uint32_t a0 = m0 & keep, a1 = m1 & keep;
    uint32_t c0 = k0 >> s;
    const uint32_t c1 = k1 >> s;
    if (r == 0) c0 ^= c1;                       // k1^2
    uint32_t n0, n1;
    gf4_mul(a0, a1, c0, c1, n0, n1);
    k0 ^= n0;
    k1 ^= n1;
    if (r < 3) {                                // the last round needs k
      uint32_t b0 = m0 >> s;
      const uint32_t b1 = m1 >> s;
      if (r == 0) b0 ^= b1;                     // m1^2
      gf4_mul(a0, a1, b0, b1, m0, m1);
    }
  }
  const uint32_t keep1 = ~(1u << 15);
  const uint32_t sigma = (k0 >> 1) & keep1, kappa = (k1 >> 1) & keep1;
  const uint32_t h = x ^ (sigma & a) ^ kappa;
  d0 = interleave(__byte_perm(a, h, 0x5140));
  d1 = interleave(__byte_perm(a, h, 0x7362));
}

__global__ void encode_vec_kernel(const int4* __restrict__ gx,
                                  const int4* __restrict__ gy,
                                  longlong2* __restrict__ out,
                                  long long quads, uint32_t lo_mask,
                                  const int32_t* __restrict__ tx,
                                  const int32_t* __restrict__ ty,
                                  int64_t* __restrict__ tout, int tail) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = tid; i < quads; i += stride) {
    const int4 x = __ldcs(gx + i), y = __ldcs(gy + i);
    uint32_t d0, d1, d2, d3;
    encode_two(x.x, x.y, y.x, y.y, lo_mask, d0, d1);
    encode_two(x.z, x.w, y.z, y.w, lo_mask, d2, d3);
    __stcs(out + 2 * i, make_longlong2(d0, d1));
    __stcs(out + 2 * i + 1, make_longlong2(d2, d3));
  }
  if (tid < tail) {                   // the last N % 4 points
    uint32_t d, unused;
    encode_two(tx[tid], 0u, ty[tid], 0u, lo_mask, d, unused);
    tout[tid] = static_cast<int64_t>(d);
  }
}

// Any alignment: one point a thread, the same arithmetic.
__global__ void encode_scalar_kernel(const int32_t* __restrict__ gx,
                                     const int32_t* __restrict__ gy,
                                     int64_t* __restrict__ out, long long n,
                                     uint32_t lo_mask) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    uint32_t d, unused;
    encode_two(gx[i], 0u, gy[i], 0u, lo_mask, d, unused);
    out[i] = static_cast<int64_t>(d);
  }
}

constexpr int kThreads = 256;

unsigned grid_for(long long work, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long cap = 8LL * sms;    // 8 blocks of 256 an SM, strided
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// A thread a point, up to 64 blocks an SM, strided beyond.
void launch_loop(const int32_t* gx, const int32_t* gy, int64_t* out,
                 long long n, int order, cudaStream_t st) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  encode_loop_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      gx, gy, out, n, order);
}

}  // namespace

// gx, gy (N,) int32; out (N,) int64; order in [1, 31].  Orders up to 16
// take the all-planes design (vector loads when gx, gy and out are all
// 16-byte aligned), the rest the plane loop.  Returns cudaGetLastError().
extern "C" int hilbert_encode(int device, const void* gx, const void* gy,
                              void* out, long long n, int order,
                              void* stream) {
  if (order < 1 || order > 31 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int32_t* x = static_cast<const int32_t*>(gx);
  const int32_t* y = static_cast<const int32_t*>(gy);
  int64_t* o = static_cast<int64_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (order > 16) {
    launch_loop(x, y, o, n, order, st);
    return static_cast<int>(cudaGetLastError());
  }
  const uint32_t plane = (1u << order) - 1u;
  const uint32_t lo_mask = plane | (plane << 16);
  const bool aligned = ((reinterpret_cast<uintptr_t>(gx) |
                         reinterpret_cast<uintptr_t>(gy) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (aligned) {
    const long long quads = n / 4;
    const int tail = static_cast<int>(n - 4 * quads);
    encode_vec_kernel<<<grid_for(quads > 0 ? quads : 1, device), kThreads,
                        0, st>>>(
        reinterpret_cast<const int4*>(x), reinterpret_cast<const int4*>(y),
        reinterpret_cast<longlong2*>(o), quads, lo_mask, x + 4 * quads,
        y + 4 * quads, o + 4 * quads, tail);
  } else {
    encode_scalar_kernel<<<grid_for(n, device), kThreads, 0, st>>>(
        x, y, o, n, lo_mask);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plane loop for every order, kept as a yardstick.
extern "C" int hilbert_encode_v1(int device, const void* gx, const void* gy,
                                 void* out, long long n, int order,
                                 void* stream) {
  if (order < 1 || order > 31 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  launch_loop(static_cast<const int32_t*>(gx),
              static_cast<const int32_t*>(gy), static_cast<int64_t*>(out), n,
              order, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hilbert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
