// Mamba2 SSD intra-chunk block for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py:41
// intra_chunk_pallas (_ssd_kernel, kernel.py:25-38).  Per chunk of Q
// steps and per head it computes, in IEEE float32 (FFMA, no TF32):
//
//   G = C . B^T                                   (Q x S . S x Q)
//   M = where(i >= j, G * exp(cl_i - cl_j), 0) * dt_j
//   Y = M . X                                     (Q x P)
//
// Layout.  The kernel takes the natural layout and writes y_intra in
// it: x (B, L, H, P), dt and cl (B, L, H), b and c (B, L, G, S), all
// float32 and contiguous, y (B, L, H, P) float32; head h reads group
// h / (H / G).  The reference flattens (batch, head, chunk) into one grid
// axis, and to do so repeats B and C over the heads (H / G = 64 times in
// Mamba2-1.3B) and recomputes G = C . B^T for every head.  Here G depends
// only on (batch, chunk, group): a block owns one (batch, chunk, group)
// and a run of that group's heads, stages the chunk's C and B rows once
// in dynamic shared memory (transposed, so a thread's rows are
// contiguous), computes the causal half of G once, and then, for each
// head of its run, forms M from G and that head's cl and dt and writes
// Y = M . X_h.  No repeated copy of B or C exists, and no moveaxis copy
// of the flat layout.
//
// Work.  Every j > i term is skipped: G is computed in 8 x 8 tiles of
// its lower triangle only; M is formed on the lower triangle and the
// diagonal 4 x 4 blocks; the Y loop of a row tile stops at its last row.
// Threads pair column or row tiles t and Q - 1 - t, so every thread does
// the same work whatever t is.  A thread of the Y product owns two row
// tiles of 4 rows and 4 columns; each step of j is one 16-byte shared
// load of M's column, one of X's row, and 16 FFMA.  One block owns its
// outputs whole: no atomics, and each output is summed over j in
// ascending order.
//
// Bound on the H100 (at Mamba2-1.3B prefill, B = 4, L = 32,768, Q = 128,
// S = 128, P = 64, H = 64, G = 1): bytes.  x read and y written are
// 2 x 2.15 GB a launch, 1.28 ms at 3.35 TB/s; the causal operations are
// about 72 GFLOP (G: 1,024 chunks x 2.1 MFLOP; Y: 65,536 head-chunks x
// 1.06 MFLOP), 1.07 ms at 67 TFLOP/s of float32 outside the tensor cores.
// Sharing G across a run of heads keeps the operations below the bytes;
// recomputing it per head, as the reference does, would be 208 GFLOP,
// 3.1 ms.  Shared memory (about 200 KB at Q = S = 128) allows one block
// an SM, 8 warps, too few to hide load latency by occupancy.  So each
// thread keeps the next head's X rows, cl and dt in flight in registers
// (16-byte loads) while the block computes the current head, and the
// first head's loads start before G is computed.  wgmma, TMA and a
// 3xTF32 split are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 128;                      // Q, S and P at most
constexpr int kXVec = kMaxDim * kMaxDim / 4 / kThreads;   // float4 a thread

struct Dims {
  long long batch, len;
  int heads, groups, q, p, s, run;   // run: heads a block serves
};

__host__ __device__ inline int ld_of(int q) { return q + 4; }

// floats of the C^T + B^T staging, or of M^T + X_h once G is done
__host__ __device__ inline int union_floats(int q, int p, int s) {
  const int stage = 2 * s * ld_of(q), heads = q * ld_of(q) + q * p;
  return stage > heads ? stage : heads;
}

__host__ inline size_t smem_bytes(int q, int p, int s) {
  return sizeof(float) *
         (static_cast<size_t>(q) * ld_of(q) + union_floats(q, p, s) + 2 * q);
}

// One head's X rows (as float4), cl and dt, held in registers.
struct HeadRegs {
  float4 x[kXVec];
  float cl, dt;
};

__device__ __forceinline__ void load_head(HeadRegs& r, const float* x,
                                          const float* dt, const float* cl,
                                          long long t0, int h, const Dims& d) {
  const int pv = d.p / 4, nvec = d.q * pv;
#pragma unroll
  for (int u = 0; u < kXVec; ++u) {
    const int e = u * kThreads + threadIdx.x;
    if (e < nvec) {
      const int j = e / pv, k = e - j * pv;
      r.x[u] = *reinterpret_cast<const float4*>(
          x + ((t0 + j) * d.heads + h) * d.p + 4 * k);
    }
  }
  if (threadIdx.x < d.q) {
    r.cl = cl[(t0 + threadIdx.x) * d.heads + h];
    r.dt = dt[(t0 + threadIdx.x) * d.heads + h];
  }
}

__device__ __forceinline__ void store_head(const HeadRegs& r, float* xs,
                                           float* cls, float* dts,
                                           const Dims& d) {
  const int nvec = d.q * (d.p / 4);
#pragma unroll
  for (int u = 0; u < kXVec; ++u) {
    const int e = u * kThreads + threadIdx.x;
    if (e < nvec) reinterpret_cast<float4*>(xs)[e] = r.x[u];
  }
  if (threadIdx.x < d.q) {
    cls[threadIdx.x] = r.cl;
    dts[threadIdx.x] = r.dt;
  }
}

__global__ void __launch_bounds__(kThreads)
intra_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ cl, const float* __restrict__ b,
                   const float* __restrict__ c, float* __restrict__ y,
                   Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int q = d.q, p = d.p, s = d.s, ld = ld_of(q);
  float* gt = smem;                       // G^T: gt[j * ld + i] = G[i][j]
  float* ct = gt + q * ld;                // C^T: ct[k * ld + i]
  float* bt = ct + s * ld;                // B^T: bt[k * ld + j]
  float* mt = ct;                         // M^T over C^T once G is done
  float* xs = mt + q * ld;                // X_h: xs[j * p + col]
  float* cls = ct + union_floats(q, p, s);
  float* dts = cls + q;

  const int rep = d.heads / d.groups;
  const int runs = rep / d.run;
  long long bid = blockIdx.x;
  const int run = static_cast<int>(bid % runs);
  bid /= runs;
  const int g = static_cast<int>(bid % d.groups);
  bid /= d.groups;
  const long long nc = d.len / q;
  const long long n = bid % nc;
  const long long bb = bid / nc;
  const long long t0 = bb * d.len + n * q;      // first step of the chunk
  const int h0 = g * rep + run * d.run;
  const int tid = threadIdx.x;

  // ---- stage C and B of the chunk, transposed; first head in flight ----
  const int sv = s / 4;
  for (int e = tid; e < q * sv; e += kThreads) {
    const int i = e / sv, k = 4 * (e - i * sv);
    const long long off = ((t0 + i) * d.groups + g) * s + k;
    const float4 cv = *reinterpret_cast<const float4*>(c + off);
    const float4 bv = *reinterpret_cast<const float4*>(b + off);
    ct[k * ld + i] = cv.x;
    ct[(k + 1) * ld + i] = cv.y;
    ct[(k + 2) * ld + i] = cv.z;
    ct[(k + 3) * ld + i] = cv.w;
    bt[k * ld + i] = bv.x;
    bt[(k + 1) * ld + i] = bv.y;
    bt[(k + 2) * ld + i] = bv.z;
    bt[(k + 3) * ld + i] = bv.w;
  }
  HeadRegs next;
  load_head(next, x, dt, cl, t0, h0, d);
  __syncthreads();

  // ---- G = C . B^T on the lower-triangular 8 x 8 tiles ----
  const int nt = q / 8;
  for (int w = tid; w < nt * (nt + 1) / 2; w += kThreads) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= w) ++ti;
    const int i0 = ti * 8, j0 = (w - ti * (ti + 1) / 2) * 8;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[r][k] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < s; ++k) {
      const float4 c0 = *reinterpret_cast<const float4*>(ct + k * ld + i0);
      const float4 c1 = *reinterpret_cast<const float4*>(ct + k * ld + i0 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bt + k * ld + j0);
      const float4 b1 = *reinterpret_cast<const float4*>(bt + k * ld + j0 + 4);
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[r][jj] = fmaf(cv[r], bv[jj], acc[r][jj]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) gt[(j0 + jj) * ld + i0 + r] = acc[r][jj];
  }
  __syncthreads();                        // C^T and B^T are free now

  const int ncol = p / 4, npair = q / 8;
  for (int hh = 0; hh < d.run; ++hh) {
    const int h = h0 + hh;
    store_head(next, xs, cls, dts, d);
    __syncthreads();
    if (hh + 1 < d.run) load_head(next, x, dt, cl, t0, h + 1, d);

    // ---- M^T[j][i] = where(j <= i, G[i][j] * exp(cl_i - cl_j), 0) * dt_j,
    // on j <= (i | 3): the Y loop reads no further.  Work item (i, phase)
    // covers columns i and q - 1 - i, every 4th j from its phase.
    for (int w = tid; w < (q / 2) * 4; w += kThreads) {
      const int pi = w % (q / 2), phase = w / (q / 2);
#pragma unroll 1
      for (int side = 0; side < 2; ++side) {
        const int i = side == 0 ? pi : q - 1 - pi;
        const float cli = cls[i];
        for (int j = phase; j <= (i | 3); j += 4)
          mt[j * ld + i] =
              j <= i ? (gt[j * ld + i] * expf(cli - cls[j])) * dts[j] : 0.0f;
      }
    }
    __syncthreads();

    // ---- Y = M . X_h: row tiles t and q/4 - 1 - t, 4 columns ----
    for (int w = tid; w < npair * ncol; w += kThreads) {
      const int t = w / ncol, col = (w - t * ncol) * 4;
#pragma unroll 1
      for (int side = 0; side < 2; ++side) {
        const int i0 = 4 * (side == 0 ? t : q / 4 - 1 - t);
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
#pragma unroll 4
        for (int j = 0; j < i0 + 4; ++j) {
          const float4 m = *reinterpret_cast<const float4*>(mt + j * ld + i0);
          const float4 xv = *reinterpret_cast<const float4*>(xs + j * p + col);
          const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][0] = fmaf(mv[r], xv.x, acc[r][0]);
            acc[r][1] = fmaf(mv[r], xv.y, acc[r][1]);
            acc[r][2] = fmaf(mv[r], xv.z, acc[r][2]);
            acc[r][3] = fmaf(mv[r], xv.w, acc[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(y + ((t0 + i0 + r) * d.heads + h) * p +
                                     col) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();                      // before the next head's staging
  }
}

}  // namespace

// x (B, L, H, P), dt/cl (B, L, H), b/c (B, L, G, S) float32 contiguous;
// y (B, L, H, P) float32.  Needs L % Q == 0, Q % 8 == 0, P % 4 == 0,
// S % 4 == 0, Q, P, S <= 128, H % G == 0 and (H / G) % run == 0; every
// pointer 16-byte aligned.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int ssd_intra_chunk(int device, const void* x, const void* dt,
                               const void* cl, const void* b, const void* c,
                               void* y, long long batch, long long len,
                               int heads, int groups, int q, int p, int s,
                               int run, void* stream) {
  if (q < 8 || q > kMaxDim || q % 8 || p < 4 || p > kMaxDim || p % 4 ||
      s < 4 || s > kMaxDim || s % 4 || groups < 1 || heads % groups ||
      run < 1 || (heads / groups) % run || len < q || len % q || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(q, p, s);
  err = cudaFuncSetAttribute(intra_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dims d{batch, len, heads, groups, q, p, s, run};
  const long long blocks = batch * (len / q) * groups * ((heads / groups) / run);
  intra_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cl), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel the device holds at once at (q, p, s): blocks an
// SM by the occupancy calculator (shared memory allows one at
// Q = S = 128) times the SM count.  The wrapper sizes a block's run of
// heads so the grid fills this.
extern "C" int ssd_resident_blocks(int device, int q, int p, int s,
                                   int* out) {
  if (q < 8 || q > kMaxDim || p < 4 || p > kMaxDim || s < 4 || s > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(q, p, s);
  err = cudaFuncSetAttribute(intra_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, intra_chunk_kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms;
  return 0;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
