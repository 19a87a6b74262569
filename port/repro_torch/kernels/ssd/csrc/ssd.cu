// Mamba2 SSD intra-chunk block for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py:41
// intra_chunk_pallas (_ssd_kernel, kernel.py:25-38).  Per chunk of Q
// steps and per head it computes, to about float32 accuracy:
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
// and a run of that group's heads, computes the causal half of G once,
// and then, for each head of its run, forms M from G and that head's cl
// and dt and writes Y = M . X_h.  No repeated copy of B or C exists, no
// moveaxis copy of the flat layout, no atomics, and each output is
// written once.
//
// Bound on the H100 (at Mamba2-1.3B prefill, B = 4, L = 32,768, Q = 128,
// S = 128, P = 64, H = 64, G = 1): bytes.  x read and y written are
// 2 x 2.15 GB a launch, 1.28 ms at 3.35 TB/s; the causal products are
// about 72 GFLOP, 1.07 ms at 67 TFLOP/s of float32 outside the tensor
// cores.
//
// intra_chunk_tc, the kernel the wrapper launches.  Both products run on
// the tensor cores, mma.sync.m16n8k8 with TF32 inputs and float32
// accumulators, each product split in three terms: a = a_hi + a_lo with
// a_hi = cvt.rna.tf32(a) and a_lo = cvt.rna.tf32(a - a_hi), the same for
// b, and a . b ~ a_lo . b_hi + a_hi . b_lo + a_hi . b_hi (the dropped
// a_lo . b_lo and the rounding of a_lo are about 2^-21 of each product).
// A block is four warps; the chunk's 16-row strips pair up as w and
// 7 - w, so every warp does the same causal work.  A warp keeps its two
// strips of G in its accumulator registers for the whole run of heads
// (18 tiles of 16 x 8) and forms each head's M straight from them: the
// k index of the Y product is permuted inside each 8-wide k tile (slot t
// <-> column 2t, slot t + 4 <-> column 2t + 1), so an accumulator
// fragment of G is an A fragment of M with no shuffle, and the B
// fragment (X_h) reads rows 2t and 2t + 1.  Tiles above the diagonal are
// never computed in G or in Y; the diagonal 16 x 16 blocks are masked.
// C and B are read from global memory once a block (16-byte loads, the
// k index permuted the same way within 16-wide groups).  Each head's X_h
// is split once, by the whole block, into hi and lo in fragment order,
// so a lane's B fragments of all three terms are one 16-byte shared
// load and the product loop does no conversion; each term runs over the
// eight column tiles before the next, so consecutive tensor-core
// instructions never share an accumulator.  X_h, cl and dt of the next
// head are staged by cp.async while the current head computes: 100 KB a
// block at P = 64, two blocks (8 warps) an SM, no register spills.
//
// intra_chunk_v1, the first design (scalar FFMA), a yardstick off the path
// (ssd_intra_chunk version 1): both products as scalar FFMA from shared memory,
// about 200 KB of staging, one 256-thread block an SM, the next head's
// X rows, cl and dt prefetched in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 128;                      // Q, S and P at most

struct Dims {
  long long batch, len;
  int heads, groups, q, p, s, run;   // run: heads a block serves
};

// ---------------------------------------------------------------------
// intra_chunk_tc: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;   // four warps
constexpr int kStrips = 8;      // 16-row strips of a 128-step chunk
constexpr int kGTiles = 18;     // G tiles a warp holds: strips w and 7 - w
constexpr int kYTiles = 8;      // Y tiles (8 columns each) of one pass

__host__ __device__ inline int pad_to(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared memory of a block, in floats: X_h as copied (rows padded to
// x_ld so the split pass reads without bank conflicts), cl and dt of two
// heads, and X_h split in fragment order.
struct Smem {
  int qp, pp, x_ld;
  __host__ __device__ explicit Smem(int q, int p)
      : qp(pad_to(q, 16)), pp(pad_to(p, 8)), x_ld(pad_to(p, 8) + 4) {}
  __host__ __device__ int raw() const { return 0; }
  __host__ __device__ int cl(int k) const { return qp * x_ld + 2 * qp * k; }
  __host__ __device__ int dt(int k) const { return cl(k) + qp; }
  __host__ __device__ int split() const { return cl(2); }
  __host__ __device__ int floats() const { return split() + 2 * qp * pp; }
};

__host__ inline size_t smem_bytes(int q, int p) {
  return sizeof(float) * static_cast<size_t>(Smem(q, p).floats());
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

struct Frag {            // an A fragment, split
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ Frag split4(float a0, float a1, float a2,
                                       float a3) {
  Frag f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in three TF32 terms, the small ones first; b = (b0, b1)
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(d, a.lo, h0, h1);
  mma(d, a.hi, l0, l1);
  mma(d, a.hi, h0, h1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Issue the copies of head h's X rows into the raw area and its cl and
// dt into half k.  Rows past q and columns past p are never written
// (zeroed at start).
__device__ __forceinline__ void stage_head(float* smem, const Smem& m,
                                           int k, const float* x,
                                           const float* dt, const float* cl,
                                           long long t0, int h,
                                           const Dims& d) {
  // a thread copies one 16-byte column chunk of every rows-th row
  const int pv = d.p / 4, rows = kThreads / pv;
  const int c = 4 * (threadIdx.x % pv), j0 = threadIdx.x / pv;
  if (j0 < rows) {
    const float* src = x + (t0 * d.heads + h) * d.p + c;
    for (int j = j0; j < d.q; j += rows)
      cp_async16(smem + m.raw() + j * m.x_ld + c,
                 src + static_cast<long long>(j) * d.heads * d.p);
  }
  for (int i = threadIdx.x; i < d.q; i += kThreads) {
    cp_async4(smem + m.cl(k) + i, cl + (t0 + i) * d.heads + h);
    cp_async4(smem + m.dt(k) + i, dt + (t0 + i) * d.heads + h);
  }
}

// X_h split in fragment order: for k tile kt, column n and lane slot t,
// the float4 (hi X[j][n], hi X[j + 1][n], lo X[j][n], lo X[j + 1][n])
// with j = 8 kt + 2 t, so a lane's B fragments of all three terms are
// one conflict-free 16-byte load.
__device__ __forceinline__ void split_head(float* smem, const Smem& m) {
  const float* raw = smem + m.raw();
  float4* out = reinterpret_cast<float4*>(smem + m.split());
  const int t = threadIdx.x & 3;
#pragma unroll 2
  for (int kt = 0; kt < m.qp / 8; ++kt) {
    const float* r0 = raw + (8 * kt + 2 * t) * m.x_ld;
    for (int n = threadIdx.x >> 2; n < m.pp; n += kThreads / 4) {
      uint32_t h0, l0, h1, l1;
      split(r0[n], h0, l0);
      split(r0[m.x_ld + n], h1, l1);
      out[(kt * m.pp + n) * 4 + t] =
          make_float4(__uint_as_float(h0), __uint_as_float(h1),
                      __uint_as_float(l0), __uint_as_float(l1));
    }
  }
}

// C or B rows of the chunk: float4 at (row, k), 0 past q or s
__device__ __forceinline__ float4 load_rows(const float* mat, long long t0,
                                            int row, int k, int g,
                                            const Dims& d) {
  if (row >= d.q || k >= d.s) return make_float4(0.f, 0.f, 0.f, 0.f);
  return __ldg(reinterpret_cast<const float4*>(
      mat + ((t0 + row) * d.groups + g) * d.s + k));
}

// One 16-row strip's causal tiles of G = C . B^T into acc[0 .. 2 strip
// + 1], or acc[17 - kt] for a warp's second strip (REV).  Within each
// 16-wide k group a lane reads C[row][k0 + 4t .. + 3]: k tile 0 takes
// (4t, 4t + 1) as slots (t, t + 4), tile 1 (4t + 2, 4t + 3); B's
// fragments read the same k of their rows.
template <bool REV>
__device__ __forceinline__ void g_strip(float (&acc)[kGTiles][4], int strip,
                                        const float* b, const float* c,
                                        long long t0, int grp,
                                        const Dims& d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nk = 2 * strip + 2;
  constexpr int kMaxN = REV ? 16 : 8;
  for (int k0 = 0; k0 < d.s; k0 += 16) {
    const int k = k0 + 4 * t;
    const float4 r0 = load_rows(c, t0, 16 * strip + g, k, grp, d);
    const float4 r1 = load_rows(c, t0, 16 * strip + g + 8, k, grp, d);
    const Frag a0 = split4(r0.x, r1.x, r0.y, r1.y);
    const Frag a1 = split4(r0.z, r1.z, r0.w, r1.w);
#pragma unroll
    for (int nt = 0; nt < kMaxN; ++nt) {
      if (nt < nk) {
        float(&an)[4] = acc[REV ? kGTiles - 1 - nt : nt];
        const float4 bv = load_rows(b, t0, 8 * nt + g, k, grp, d);
        mma3(an, a0, bv.x, bv.y);
        mma3(an, a1, bv.z, bv.w);
      }
    }
  }
}

// One 16-row strip's Y = M . X_h for the head staged in the split area
// and cl / dt half k.  G's tile kt of this strip is acc[kt], or
// acc[17 - kt] for a warp's second strip (REV).  Each term's products
// run over all eight column tiles before the next term's, so no two
// consecutive tensor-core instructions share an accumulator.  Rows past
// q and columns past p are not stored.
template <bool REV>
__device__ __forceinline__ void y_strip(const float (&acc)[kGTiles][4],
                                        int strip, const float* smem,
                                        const Smem& m, int k, float* y,
                                        long long t0, int h, const Dims& d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* cls = smem + m.cl(k);
  const float* dts = smem + m.dt(k);
  const float4* xs = reinterpret_cast<const float4*>(smem + m.split());
  const int nk = 2 * strip + 2, i0 = 16 * strip + g, i1 = i0 + 8;
  const float cl0 = cls[i0], cl1 = cls[i1];
  constexpr int kMaxK = REV ? 16 : 8;
  for (int n0 = 0; n0 < d.p; n0 += 8 * kYTiles) {
    float ya[kYTiles][4];
#pragma unroll
    for (int nt = 0; nt < kYTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[nt][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kMaxK; ++kt) {
      if (kt < nk) {
        const float(&gk)[4] = acc[REV ? kGTiles - 1 - kt : kt];
        const int j = 8 * kt + 2 * t;          // M columns j and j + 1
        float4 bx[kYTiles];
#pragma unroll
        for (int nt = 0; nt < kYTiles; ++nt)
          if (n0 + 8 * nt < d.p)
            bx[nt] = xs[(kt * m.pp + n0 + 8 * nt + g) * 4 + t];
        const float2 clj = *reinterpret_cast<const float2*>(cls + j);
        const float2 dtj = *reinterpret_cast<const float2*>(dts + j);
        // exp of the difference: the decay is accurate where it is
        // large (|cl_i - cl_j| small), tiny where it is not
        float m00 = (gk[0] * __expf(cl0 - clj.x)) * dtj.x;   // (i0, j)
        float m01 = (gk[1] * __expf(cl0 - clj.y)) * dtj.y;   // (i0, j + 1)
        float m10 = (gk[2] * __expf(cl1 - clj.x)) * dtj.x;   // (i1, j)
        float m11 = (gk[3] * __expf(cl1 - clj.y)) * dtj.y;   // (i1, j + 1)
        if (kt >= 2 * strip) {                 // the diagonal block
          m00 = j <= i0 ? m00 : 0.f;
          m01 = j + 1 <= i0 ? m01 : 0.f;
          m10 = j <= i1 ? m10 : 0.f;
          m11 = j + 1 <= i1 ? m11 : 0.f;
        }
        // slot t <-> column j, slot t + 4 <-> column j + 1
        const Frag a = split4(m00, m10, m01, m11);
#pragma unroll
        for (int nt = 0; nt < kYTiles; ++nt)
          if (n0 + 8 * nt < d.p)
            mma(ya[nt], a.lo, __float_as_uint(bx[nt].x),
                __float_as_uint(bx[nt].y));
#pragma unroll
        for (int nt = 0; nt < kYTiles; ++nt)
          if (n0 + 8 * nt < d.p)
            mma(ya[nt], a.hi, __float_as_uint(bx[nt].z),
                __float_as_uint(bx[nt].w));
#pragma unroll
        for (int nt = 0; nt < kYTiles; ++nt)
          if (n0 + 8 * nt < d.p)
            mma(ya[nt], a.hi, __float_as_uint(bx[nt].x),
                __float_as_uint(bx[nt].y));
      }
    }
#pragma unroll
    for (int nt = 0; nt < kYTiles; ++nt) {
      const int col = n0 + 8 * nt + 2 * t;
      if (col < d.p) {
        if (i0 < d.q)
          *reinterpret_cast<float2*>(y + ((t0 + i0) * d.heads + h) * d.p +
                                     col) = make_float2(ya[nt][0], ya[nt][1]);
        if (i1 < d.q)
          *reinterpret_cast<float2*>(y + ((t0 + i1) * d.heads + h) * d.p +
                                     col) = make_float2(ya[nt][2], ya[nt][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
intra_chunk_tc(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ cl, const float* __restrict__ b,
               const float* __restrict__ c, float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int rep = d.heads / d.groups;
  const int runs = rep / d.run;
  long long bid = blockIdx.x;
  const int run = static_cast<int>(bid % runs);
  bid /= runs;
  const int grp = static_cast<int>(bid % d.groups);
  bid /= d.groups;
  const long long nc = d.len / d.q;
  const long long t0 = (bid / nc) * d.len + (bid % nc) * d.q;
  const int h0 = grp * rep + run * d.run;
  const int tid = threadIdx.x, warp = tid >> 5;
  const Smem m(d.q, d.p);
  const int ns = m.qp / 16;
  const int sa = warp, sb = kStrips - 1 - warp;   // this warp's strips
  const bool live_a = sa < ns, live_b = sb < ns;

  for (int e = tid; e < m.split(); e += kThreads) smem[e] = 0.f;
  __syncthreads();
  stage_head(smem, m, 0, x, dt, cl, t0, h0, d);
  cp_async_commit();

  // ---- G = C . B^T, the causal tiles of strips sa and sb ----
  float acc[kGTiles][4];
#pragma unroll
  for (int n = 0; n < kGTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if (live_a) g_strip<false>(acc, sa, b, c, t0, grp, d);
  if (live_b) g_strip<true>(acc, sb, b, c, t0, grp, d);

  // ---- per head: split X_h, stage the next head, Y = M . X_h ----
  for (int hh = 0; hh < d.run; ++hh) {
    cp_async_wait_all();
    __syncthreads();        // head hh landed; head hh - 1 is done with it
    split_head(smem, m);
    __syncthreads();        // the split is ready; the raw area is free
    if (hh + 1 < d.run) {
      stage_head(smem, m, (hh + 1) & 1, x, dt, cl, t0, h0 + hh + 1, d);
      cp_async_commit();
    }
    if (live_a) y_strip<false>(acc, sa, smem, m, hh & 1, y, t0, h0 + hh, d);
    if (live_b) y_strip<true>(acc, sb, smem, m, hh & 1, y, t0, h0 + hh, d);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------
// intra_chunk_v1: the scalar-FFMA design, a yardstick
// ---------------------------------------------------------------------

namespace v1 {


constexpr int kThreads = 256;
constexpr int kXVec = kMaxDim * kMaxDim / 4 / kThreads;   // float4 a thread

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
intra_chunk_v1(const float* __restrict__ x, const float* __restrict__ dt,
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


}  // namespace v1

// Shapes both kernels take.
bool bad_shape(long long batch, long long len, int heads, int groups, int q,
               int p, int s, int run) {
  return q < 8 || q > kMaxDim || q % 8 || p < 4 || p > kMaxDim || p % 4 ||
         s < 4 || s > kMaxDim || s % 4 || groups < 1 || heads % groups ||
         run < 1 || (heads / groups) % run || len < q || len % q ||
         batch < 1;
}

template <typename Kernel>
int launch(Kernel kernel, size_t bytes, int threads, int device,
           const void* x, const void* dt, const void* cl, const void* b,
           const void* c, void* y, const Dims& d, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      d.batch * (d.len / d.q) * d.groups * ((d.heads / d.groups) / d.run);
  kernel<<<static_cast<unsigned>(blocks), threads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cl), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int resident(Kernel kernel, size_t bytes, int threads, int device,
             int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = per_sm * sms;
  return 0;
}

}  // namespace

// x (B, L, H, P), dt/cl (B, L, H), b/c (B, L, G, S) float32 contiguous;
// y (B, L, H, P) float32.  Needs L % Q == 0, Q % 8 == 0, P % 4 == 0,
// S % 4 == 0, Q, P, S <= 128, H % G == 0 and (H / G) % run == 0; every
// pointer 16-byte aligned.  version 2 launches intra_chunk_tc, 1
// intra_chunk_v1.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// shapes it does not take.
extern "C" int ssd_intra_chunk(int version, int device, const void* x,
                               const void* dt, const void* cl,
                               const void* b, const void* c, void* y,
                               long long batch, long long len, int heads,
                               int groups, int q, int p, int s, int run,
                               void* stream) {
  if (bad_shape(batch, len, heads, groups, q, p, s, run) ||
      (version != 1 && version != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{batch, len, heads, groups, q, p, s, run};
  if (version == 1)
    return launch(v1::intra_chunk_v1, v1::smem_bytes(q, p, s), v1::kThreads,
                  device, x, dt, cl, b, c, y, d, stream);
  return launch(tc::intra_chunk_tc, tc::smem_bytes(q, p), tc::kThreads,
                device, x, dt, cl, b, c, y, d, stream);
}

// Blocks of a kernel version the device holds at once at (q, p, s):
// blocks an SM by the occupancy calculator times the SM count.  The
// wrapper sizes a block's run of heads so the grid fills this.
extern "C" int ssd_resident_blocks(int version, int device, int q, int p,
                                   int s, int* out) {
  if (q < 8 || q > kMaxDim || p < 4 || p > kMaxDim || s < 4 || s > kMaxDim ||
      (version != 1 && version != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (version == 1)
    return resident(v1::intra_chunk_v1, v1::smem_bytes(q, p, s),
                    v1::kThreads, device, out);
  return resident(tc::intra_chunk_tc, tc::smem_bytes(q, p), tc::kThreads,
                  device, out);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
