// ssd_scan_bwd: the gradient of ssd_chunk_scan's intra-chunk part (Mamba-2's
// SSD), written by hand for Hopper (sm_90a).
//
// The reference has no backward kernel: JAX differentiates ssd_chunked
// (repro/models/mamba2.py:63) inside the mamba2 loss.  This kernel is the
// transpose of the forward kernel's products (csrc/ssd_scan.cu).  For each
// batch b, chunk c of Q positions and head h, in fp32, with xdt = x dt,
// G = C B^T (Q x Q, shared by all heads), Lm[l, s] = exp(a[l] - a[s]) for
// s <= l and 0 above the diagonal (a = the forward's a_cs), M = Lm o G,
// decay[s] = exp(a[Q-1] - a[s]), w = xdt o decay and R = B dst^T:
//
//     dM    = dy xdt^T                    dxdt = M^T dy + decay o R
//     dG    = sum_h dM o Lm               dC   = dG B
//     dB    = dG^T C + sum_h w dst        dT   = dM o M
//     d a   = da_in + rowsum(dT) - colsum(dT) - u  (+ sum_s u[s] at Q-1),
//             u = rowsum(w o R)
//     da    = the reverse cumulative sum of d a
//     ddt   = da A + rowsum(dxdt o x),  dA = sum da dt,  dx = dxdt dt
//
// from the cotangents dy (B, C, H, Q, P), dst (B, C, H, P, N) and da_in
// (B, C, H, Q), all fp32, that the wrapper's inter-chunk torch ops hand
// back.  x, B and C are fp32 or bf16 (dx, dB and dC come back in that
// dtype), dt and A fp32.
//
// What bounds it: at mamba2-130m (B 4, L 2048, H 24, P 64, N 128, Q 256),
// counted where the decay is not zero (s <= l) as the forward's bound is,
// dM and M^T dy take Q(Q+1)P each and R and sum_h w dst 2QNP each per
// (b, c, h), 12.9 GFLOP over 768 of them; dC and dG^T C take Q(Q+1)N each
// per (b, c), 0.54 GFLOP; recomputing G another 0.27.  13.7 GFLOP at
// 67 TFLOP/s of fp32 is 0.20 ms, against ~140 MB moved, 0.04 ms:
// operations.
//
// The design: three kernels in order on the stream, 256 threads a block,
// 64-position tiles, every product an fp32 FMA on the CUDA cores from
// shared memory (a thread owns a 4 x 4 or 4 x 8 piece of a 64-row output
// tile).  Every output element and every scratch element has exactly one
// writer and no atomics are used, so two launches give equal bits.
//   1. bwd_scores: G = C B^T per (b, c), the tiles on and below the
//      diagonal, into fp32 scratch (one block a tile).
//   2. bwd_heads: a block per (b, c, pair of heads, 64-position s-tile),
//      heaviest (first s-tile) first.  It keeps both heads' xdt rows of its
//      s-tile in shared memory.  First, per head, R = B dst^T and the
//      states' term of dB, sum_{h, p} w dst over its pair (written as an
//      fp32 partial); dxdt starts as decay o R in registers.  Then it walks
//      the l-tiles at and below its s-tile: per head, dM = dy xdt^T (the dy
//      tile in shared memory), Lm, M and dT formed elementwise, M^T dy
//      added into dxdt, dT's row sums written as a partial per s-tile and
//      its column sums kept; dG summed over the pair in registers and
//      written as a partial per pair.  Last, dx = dxdt dt, and
//      rowsum(dxdt o x) into ddt, colsum(dT) + u and the tile's sum of u
//      into scratch.
//   3. bwd_chunk: three kinds of blocks.  dB tiles (b, c, s-tile): the
//      pairs' states terms plus dG^T C over the l-tiles at and below;
//      dC tiles (b, c, l-tile): dG B over the s-tiles at and above; and a
//      block per (b, c, h) that sums d a from the partials, runs the
//      reverse cumulative sum, finishes ddt and writes dA's partial for
//      (b, c, h).  The wrapper sums dA's partials over (b, c) in torch.
// What holds it back (inferred; no profiler counters on the card): the
// products are fp32 FMAs on the CUDA cores, loads are not overlapped with
// them, the pair's dG and states partials go through device memory, and
// every tile costs barriers among 8 warps.
//
// Limits, checked on the host: P <= 64, N <= 128, both multiples of 4, Q even;
// x, B, C and dy with bases and strides that allow reads of 4 elements and
// their last axis contiguous (the wrapper copies one otherwise); shared
// memory within the card's 227 KB.
//
// Interface: plain C, loaded with ctypes.  ssd_scan_bwd_scratch_floats
// gives the fp32 scratch the launch needs.  ssd_scan_bwd_launch returns
// cudaGetLastError() after the last launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take, before any launch.
// Launches on the given stream and does not synchronize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // positions per tile
constexpr int kHG = 2;          // heads per bwd_heads block
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kS = kT + 4;      // row stride of a 64-wide fp32 tile (floats)
constexpr int kNS = kMaxN + 4;  // row stride of a 128-wide fp32 tile

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* acs;   // (B, C, H, Q)
  const float* dy;    // strided (b, c, h, l), p contiguous
  const float* dst;   // (B, C, H, P, N)
  const float* dain;  // (B, C, H, Q)
  void* dx;           // (B, L, H, P)
  float* ddt;         // (B, L, H)
  float* dA;          // (B, C, H) partials
  void* dB;           // (B, L, N)
  void* dC;           // (B, L, N)
  // scratch
  float* G;      // (B, C, Q, Q)
  float* dGp;    // (B, C, NG, Q, Q)
  float* SBp;    // (B, C, NG, Q, N)
  float* rowp;   // (B, C, H, nT, Q)
  float* cpart;  // (B, C, H, Q)
  float* usum;   // (B, C, H, nT)
  int B, L, H, P, N, Q, C, nT, NG;
  int64_t xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl, ysb, ysc, ysh, ysl;
};

int64_t round4(int64_t n) { return (n + 3) & ~static_cast<int64_t>(3); }

// Offsets (floats) of the scratch's parts, each on 16 bytes.
struct Scratch {
  int64_t G, dGp, SBp, rowp, cpart, usum, total;
};

Scratch scratch_layout(int B, int L, int H, int N, int Q) {
  const int64_t C = L / Q, nT = (Q + kT - 1) / kT, NG = (H + kHG - 1) / kHG;
  Scratch s;
  s.G = 0;
  s.dGp = s.G + round4(B * C * Q * static_cast<int64_t>(Q));
  s.SBp = s.dGp + round4(B * C * NG * Q * static_cast<int64_t>(Q));
  s.rowp = s.SBp + round4(B * C * NG * Q * static_cast<int64_t>(N));
  s.cpart = s.rowp + round4(B * C * H * nT * static_cast<int64_t>(Q));
  s.usum = s.cpart + round4(B * C * H * static_cast<int64_t>(Q));
  s.total = s.usum + round4(B * C * H * nT);
  return s;
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [r0, r0 + 64) of an (rows, width) slab (row stride `ls`, width a
// multiple of 4) into an fp32 tile [r][c] of row stride `ts` and `cols`
// columns (a multiple of 4); rows past `nrows` and columns past `width` are
// zero, row r scaled by f[r] when f is given.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, int ts, int cols, const T* base, int64_t ls,
                                          int nrows, int width, const float* f) {
  const int vpr = cols / 4;
  for (int i = threadIdx.x; i < kT * vpr; i += kThreads) {
    const int r = i / vpr, v = 4 * (i % vpr);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows && v < width) {
      val = load4(base + r * ls + v);
      if (f != nullptr) {
        const float m = f[r];
        val.x *= m; val.y *= m; val.z *= m; val.w *= m;
      }
    }
    store4(&tile[r * ts + v], val);
  }
}

// The same slab stored transposed, tile[c][r] (row stride `ts`), `cols` rows.
template <typename T>
__device__ __forceinline__ void load_tile_t(float* tile, int ts, int cols, const T* base, int64_t ls,
                                            int nrows, int width) {
  const int vpr = cols / 4;
  for (int i = threadIdx.x; i < kT * vpr; i += kThreads) {
    const int r = i % kT, v = 4 * (i / kT);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows && v < width) val = load4(base + r * ls + v);
    tile[(v + 0) * ts + r] = val.x;
    tile[(v + 1) * ts + r] = val.y;
    tile[(v + 2) * ts + r] = val.z;
    tile[(v + 3) * ts + r] = val.w;
  }
}

// Outer-product form: acc[i][4 cb + j] += sum_k A[k][4 rg + i] * X[k][64 cb + 4 cg + j]
// for k < K (both operands with their reduction axis as rows).
template <int NCB>
__device__ __forceinline__ void mm_outer(float (&acc)[4][4 * NCB], const float* A, int as,
                                         const float* X, int xs, int K, int rg, int cg) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&A[k * as + 4 * rg]);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      const float4 b = *reinterpret_cast<const float4*>(&X[k * xs + 64 * cb + 4 * cg]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * cb + j] = fmaf(av[i], bv[j], acc[i][4 * cb + j]);
    }
  }
}

// Dot form: acc[i][j] += sum_k A[4 ty + i][k] * X[tx + 16 j][k] for k < K
// (K a multiple of 4; both operands with their reduction axis contiguous).
// Each row i of A is scaled by f[i] when f is given.
template <int NJ>
__device__ __forceinline__ void mm_dot(float (&acc)[4][NJ], const float* A, int as, const float* X,
                                       int xs, int K, int ty, int tx) {
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&A[(4 * ty + i) * as + k]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(&X[(tx + 16 * j) * xs + k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b.x, s);
        s = fmaf(a[i].y, b.y, s);
        s = fmaf(a[i].z, b.z, s);
        s = fmaf(a[i].w, b.w, s);
        acc[i][j] = s;
      }
    }
  }
}

// Sum over the 16 lanes that share a row (lanes 16k .. 16k + 15).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// 1. G = C B^T, the tiles at or below the diagonal.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_scores(Args a) {
  extern __shared__ float4 smem4[];
  float* Ct = reinterpret_cast<float*>(smem4);  // [64][kNS]
  float* Bt = Ct + kT * kNS;                    // [64][kNS]
  const int per_bc = a.nT * a.nT;
  const int bc = blockIdx.x / per_bc, r = blockIdx.x % per_bc;
  const int lt = r / a.nT, st = r % a.nT;
  if (st > lt) return;
  const int b = bc / a.C, c = bc % a.C;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int l0 = lt * kT, s0 = st * kT, Q = a.Q;
  const int64_t row0 = static_cast<int64_t>(c) * Q;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.csb + (row0 + l0) * a.csl;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bsb + (row0 + s0) * a.bsl;
  load_tile(Ct, kNS, kMaxN, Cb, a.csl, min(kT, Q - l0), a.N, static_cast<const float*>(nullptr));
  load_tile(Bt, kNS, kMaxN, Bb, a.bsl, min(kT, Q - s0), a.N, static_cast<const float*>(nullptr));
  __syncthreads();
  float acc[4][4] = {};
  mm_dot<4>(acc, Ct, kNS, Bt, kNS, a.N, ty, tx);
  float* G = a.G + static_cast<int64_t>(bc) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + 4 * ty + i;
    if (l >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx + 16 * j;
      if (s < Q) G[static_cast<int64_t>(l) * Q + s] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. Per (b, c, pair of heads, s-tile).
// ---------------------------------------------------------------------------

size_t heads_smem_floats(int Q) {
  // a_cs and dt of the pair (dt only for the s-tile), their column sums and
  // u, both heads' xdt tiles, and a region of two 128 x kS tiles (B^T and
  // dst^T first; the dy, M and reduction tiles after).
  return static_cast<size_t>(kHG) * Q + 3 * kHG * kT + kHG * kT * kS + 2 * kMaxN * kS;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) bwd_heads(Args a) {
  extern __shared__ float4 smem4[];
  float* acs = reinterpret_cast<float*>(smem4);  // [kHG][Q]
  float* dts = acs + kHG * a.Q;                  // [kHG][64]
  float* colacc = dts + kHG * kT;                // [kHG][64]
  float* uacc = colacc + kHG * kT;               // [kHG][64]
  float* xdt = uacc + kHG * kT;                  // [kHG][64][kS]
  float* region = xdt + kHG * kT * kS;
  float* BtT = region;                           // [128][kS]: B^T of the s-tile
  float* dstT = region + kMaxN * kS;             // [128][kS]: dst^T of a head
  float* dyt = region;                           // [64][kS]: dy of an l-tile
  float* Mt = region + kT * kS;                  // [64][kS]: M of the tile pair
  float* red = region + 2 * kT * kS;             // [16][64]: column sums

  const int Q = a.Q, P = a.P, N = a.N;
  const int per_st = a.B * a.C * a.NG;
  const int st = blockIdx.x / per_st;
  const int r = blockIdx.x % per_st;
  const int bc = r / a.NG, grp = r % a.NG;
  const int b = bc / a.C, c = bc % a.C;
  const int h0 = grp * kHG, nh = min(kHG, a.H - h0);
  const int s0 = st * kT, ns = min(kT, Q - s0);
  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;  // (rg, cg) or (ty, tx)
  const int64_t row0 = static_cast<int64_t>(c) * Q;
  const T* xb = static_cast<const T*>(a.x) + b * a.xsb + (row0 + s0) * a.xsl + h0 * a.xsh;
  const float* db = a.dt + b * a.dsb + row0 * a.dsl + h0 * a.dsh;
  const int64_t bch0 = (static_cast<int64_t>(b) * a.C + c) * a.H + h0;  // (b, c, h0)

  for (int i = tid; i < kHG * Q; i += kThreads) {
    const int h = i / Q, l = i % Q;
    acs[i] = h < nh ? a.acs[(bch0 + h) * Q + l] : 0.f;
  }
  for (int i = tid; i < kHG * kT; i += kThreads) {
    const int h = i / kT, s = i % kT;
    dts[i] = h < nh && s < ns ? db[(s0 + s) * a.dsl + h * a.dsh] : 0.f;
    colacc[i] = 0.f;
  }
  __syncthreads();
  for (int h = 0; h < kHG; ++h)
    load_tile(xdt + h * kT * kS, kS, kMaxP, xb + h * a.xsh, a.xsl, h < nh ? ns : 0, P, dts + h * kT);
  load_tile_t(BtT, kS, kMaxN, static_cast<const T*>(a.Bm) + b * a.bsb + (row0 + s0) * a.bsl, a.bsl,
              ns, N);

  // Per head: R = B dst^T, dxdt = decay o R, u, and the states' term of dB.
  float dxdt[kHG][4][4];
  float sb[4][8] = {};
#pragma unroll
  for (int h = 0; h < kHG; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dxdt[h][i][j] = 0.f;
    if (h >= nh) continue;
    __syncthreads();  // the last head's readers of dstT are done
    const float* dsth = a.dst + (bch0 + h) * P * N;
    for (int i = tid; i < P * (kMaxN / 4); i += kThreads) {
      const int p = i / (kMaxN / 4), n = 4 * (i % (kMaxN / 4));
      const float4 v = n < N ? load4(dsth + p * N + n) : make_float4(0.f, 0.f, 0.f, 0.f);
      dstT[(n + 0) * kS + p] = v.x;
      dstT[(n + 1) * kS + p] = v.y;
      dstT[(n + 2) * kS + p] = v.z;
      dstT[(n + 3) * kS + p] = v.w;
    }
    for (int i = tid; i < kMaxN * (kMaxP - P); i += kThreads)
      dstT[(i / (kMaxP - P)) * kS + P + i % (kMaxP - P)] = 0.f;
    __syncthreads();
    mm_outer<1>(dxdt[h], BtT, kS, dstT, kS, N, hi, lo);  // R[s][p], s = 4 hi + i, p = 4 lo + j
    const float* xh = xdt + h * kT * kS;
    const float alast = acs[h * Q + Q - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * hi + i;
      const float dec = s < ns ? expf(alast - acs[h * Q + s0 + s]) : 0.f;
      float u = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dxdt[h][i][j] *= dec;
        u = fmaf(xh[s * kS + 4 * lo + j], dxdt[h][i][j], u);
      }
      u = sum16(u);
      if (lo == 0) uacc[h * kT + s] = u;
    }
    // sb[s][n] += decay[s] sum_p xdt[s][p] dst[p][n], s = 4 hi + i, n = lo + 16 j.
    float t[4][8] = {};
    mm_dot<8>(t, xh, kS, dstT, kS, P, hi, lo);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * hi + i;
      const float dec = s < ns ? expf(alast - acs[h * Q + s0 + s]) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sb[i][j] = fmaf(dec, t[i][j], sb[i][j]);
    }
  }
  {
    float* out = a.SBp + ((static_cast<int64_t>(b) * a.C + c) * a.NG + grp) * Q * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * hi + i;
      if (s >= ns) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = lo + 16 * j;
        if (n < N) out[static_cast<int64_t>(s0 + s) * N + n] = sb[i][j];
      }
    }
  }

  // The l-tiles at and below the s-tile.
  const float* Gb = a.G + static_cast<int64_t>(bc) * Q * Q;
  float* dGb = a.dGp + ((static_cast<int64_t>(b) * a.C + c) * a.NG + grp) * Q * Q;
  for (int lt = st; lt < a.nT; ++lt) {
    const int l0 = lt * kT, nl = min(kT, Q - l0);
    float g[4][4], dg[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = 4 * hi + i, s = lo + 16 * j;
        g[i][j] = l < nl && s < ns ? Gb[static_cast<int64_t>(l0 + l) * Q + s0 + s] : 0.f;
        dg[i][j] = 0.f;
      }
#pragma unroll
    for (int h = 0; h < kHG; ++h) {
      if (h >= nh) continue;
      __syncthreads();  // the last readers of the region are done
      load_tile(dyt, kS, kMaxP, a.dy + b * a.ysb + c * a.ysc + (h0 + h) * a.ysh + l0 * a.ysl, a.ysl,
                nl, P, static_cast<const float*>(nullptr));
      __syncthreads();
      float dm[4][4] = {};
      mm_dot<4>(dm, dyt, kS, xdt + h * kT * kS, kS, P, hi, lo);  // dM[l][s], l = 4 hi + i, s = lo + 16 j
      float col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = 4 * hi + i;
        const float al = acs[h * Q + l0 + min(l, nl - 1)];
        float row = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = lo + 16 * j;
          const bool in = l < nl && s < ns && s0 + s <= l0 + l;
          // The exponent's argument is masked above the diagonal, where it is
          // positive and large (see csrc/ssd_scan.cu).
          const float lm = in ? expf(al - acs[h * Q + s0 + s]) : 0.f;
          const float m = lm * g[i][j];
          const float dT = dm[i][j] * m;
          dg[i][j] = fmaf(dm[i][j], lm, dg[i][j]);
          Mt[l * kS + s] = m;
          row += dT;
          col[j] += dT;
        }
        row = sum16(row);
        if (lo == 0 && l < nl)
          a.rowp[((bch0 + h) * a.nT + st) * Q + l0 + l] = row;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) red[hi * kT + lo + 16 * j] = col[j];
      __syncthreads();
      if (tid < kT) {
        float s = 0.f;
        for (int k = 0; k < 16; ++k) s += red[k * kT + tid];
        colacc[h * kT + tid] += s;
      }
      mm_outer<1>(dxdt[h], Mt, kS, dyt, kS, nl, hi, lo);  // dxdt[s][p] += sum_l M[l][s] dy[l][p]
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = 4 * hi + i;
      if (l >= nl) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = lo + 16 * j;
        if (s < ns) dGb[static_cast<int64_t>(l0 + l) * Q + s0 + s] = dg[i][j];
      }
    }
  }
  __syncthreads();  // colacc and uacc are complete

  // dx = dxdt dt, rowsum(dxdt o x) into ddt, colsum(dT) + u, sum of u.
#pragma unroll
  for (int h = 0; h < kHG; ++h) {
    if (h >= nh) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * hi + i, p = 4 * lo;
      float xp = 0.f;
      if (s < ns && p < P) {
        const float4 xv = load4(xb + h * a.xsh + s * a.xsl + p);
        xp = dxdt[h][i][0] * xv.x + dxdt[h][i][1] * xv.y + dxdt[h][i][2] * xv.z +
             dxdt[h][i][3] * xv.w;
        const float d = dts[h * kT + s];
        T* dxp = static_cast<T*>(a.dx) +
                 ((static_cast<int64_t>(b) * a.L + row0 + s0 + s) * a.H + h0 + h) * P + p;
        store4(dxp, make_float4(dxdt[h][i][0] * d, dxdt[h][i][1] * d, dxdt[h][i][2] * d,
                                dxdt[h][i][3] * d));
      }
      xp = sum16(xp);
      if (lo == 0 && s < ns)
        a.ddt[(static_cast<int64_t>(b) * a.L + row0 + s0 + s) * a.H + h0 + h] = xp;
    }
    if (tid < 32) {
      float u = 0.f;
      for (int s = tid; s < ns; s += 32) {
        u += uacc[h * kT + s];
        a.cpart[(bch0 + h) * Q + s0 + s] = -colacc[h * kT + s] - uacc[h * kT + s];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) u += __shfl_xor_sync(0xffffffffu, u, off);
      if (tid == 0) a.usum[(bch0 + h) * a.nT + st] = u;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dB and dC tiles, and d a -> ddt, dA per (b, c, h).
// ---------------------------------------------------------------------------

size_t chunk_smem_floats(int Q) {
  const size_t tiles = static_cast<size_t>(kT) * kS + static_cast<size_t>(kT) * kNS;
  const size_t scan = static_cast<size_t>(Q);
  return tiles > scan ? tiles : scan;
}

// The pairs' dG partials for the tile (l-tile lt, s-tile st), summed, into
// tile[l][s] (or tile[s][l] when transposed); zero out of range.
__device__ __forceinline__ void load_dg(float* tile, const Args& a, int64_t bc, int lt, int st,
                                        bool transposed) {
  const int Q = a.Q, l0 = lt * kT, s0 = st * kT;
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int l = i / kT, s = i % kT;
    float v = 0.f;
    if (l0 + l < Q && s0 + s < Q) {
      const float* p = a.dGp + bc * a.NG * Q * Q + static_cast<int64_t>(l0 + l) * Q + s0 + s;
      for (int g = 0; g < a.NG; ++g) v += p[static_cast<int64_t>(g) * Q * Q];
    }
    tile[transposed ? s * kS + l : l * kS + s] = v;
  }
}

template <typename T>
__device__ __forceinline__ void store_bc_tile(T* out, int64_t ls, int nrows, int N,
                                              const float (&acc)[4][8], int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
    if (r >= nrows) continue;
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {
      const int n = 64 * cb + 4 * cg;
      if (n < N)
        store4(out + r * ls + n, make_float4(acc[i][4 * cb], acc[i][4 * cb + 1],
                                             acc[i][4 * cb + 2], acc[i][4 * cb + 3]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_chunk(Args a) {
  extern __shared__ float4 smem4[];
  float* Dt = reinterpret_cast<float*>(smem4);  // [64][kS]: dG tile
  float* Xt = Dt + kT * kS;                     // [64][kNS]: B or C tile
  const int Q = a.Q, N = a.N, BC = a.B * a.C;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  int i = blockIdx.x;
  if (i < 2 * BC * a.nT) {
    const bool is_db = i < BC * a.nT;
    if (!is_db) i -= BC * a.nT;
    const int t = is_db ? i / BC : a.nT - 1 - i / BC;  // heaviest first
    const int bc = i % BC, b = bc / a.C, c = bc % a.C;
    const int64_t row0 = static_cast<int64_t>(c) * Q;
    const int r0 = t * kT, nr = min(kT, Q - r0);
    float acc[4][8] = {};
    if (is_db) {
      // dB[s][n] = sum_pairs SBp[s][n] + sum_{l >= s} dG[l][s] C[l][n].
      const float* sbp = a.SBp + static_cast<int64_t>(bc) * a.NG * Q * N;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = 4 * rg + ii;
        if (s >= nr) continue;
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {
          const int n = 64 * cb + 4 * cg;
          if (n >= N) continue;
          for (int g = 0; g < a.NG; ++g) {
            const float4 v = load4(sbp + (static_cast<int64_t>(g) * Q + r0 + s) * N + n);
            acc[ii][4 * cb] += v.x;
            acc[ii][4 * cb + 1] += v.y;
            acc[ii][4 * cb + 2] += v.z;
            acc[ii][4 * cb + 3] += v.w;
          }
        }
      }
      const T* Cb = static_cast<const T*>(a.Cm) + b * a.csb + row0 * a.csl;
      for (int lt = t; lt < a.nT; ++lt) {
        __syncthreads();
        load_dg(Dt, a, bc, lt, t, false);
        load_tile(Xt, kNS, kMaxN, Cb + lt * kT * a.csl, a.csl, min(kT, Q - lt * kT), N,
                  static_cast<const float*>(nullptr));
        __syncthreads();
        mm_outer<2>(acc, Dt, kS, Xt, kNS, min(kT, Q - lt * kT), rg, cg);
      }
      store_bc_tile(static_cast<T*>(a.dB) + b * static_cast<int64_t>(a.L) * N + (row0 + r0) * N,
                    N, nr, N, acc, rg, cg);
    } else {
      // dC[l][n] = sum_{s <= l} dG[l][s] B[s][n].
      const T* Bb = static_cast<const T*>(a.Bm) + b * a.bsb + row0 * a.bsl;
      for (int st = 0; st <= t; ++st) {
        __syncthreads();
        load_dg(Dt, a, bc, t, st, true);
        load_tile(Xt, kNS, kMaxN, Bb + st * kT * a.bsl, a.bsl, min(kT, Q - st * kT), N,
                  static_cast<const float*>(nullptr));
        __syncthreads();
        mm_outer<2>(acc, Dt, kS, Xt, kNS, min(kT, Q - st * kT), rg, cg);
      }
      store_bc_tile(static_cast<T*>(a.dC) + b * static_cast<int64_t>(a.L) * N + (row0 + r0) * N,
                    N, nr, N, acc, rg, cg);
    }
    return;
  }
  // d a_cs for (b, c, h), its reverse cumulative sum da, then ddt and dA.
  i -= 2 * BC * a.nT;
  const int bc = i / a.H, h = i % a.H, b = bc / a.C, c = bc % a.C;
  const int64_t bch = static_cast<int64_t>(bc) * a.H + h;
  const int64_t row0 = static_cast<int64_t>(c) * Q;
  float* v = reinterpret_cast<float*>(smem4);  // [Q]
  float usum = 0.f;
  for (int t = 0; t < a.nT; ++t) usum += a.usum[bch * a.nT + t];
  for (int l = tid; l < Q; l += kThreads) {
    float d = a.dain[bch * Q + l] + a.cpart[bch * Q + l];
    for (int t = 0; t <= l / kT; ++t) d += a.rowp[(bch * a.nT + t) * Q + l];
    if (l == Q - 1) d += usum;
    v[l] = d;
  }
  __syncthreads();
  if (tid < 32) {
    // Reverse inclusive scan: a run of positions a lane, a shuffle scan
    // over the runs' totals from the end.
    const int lane = tid, run = (Q + 31) / 32;
    const int lo = min(lane * run, Q), hi = min(lo + run, Q);
    float sum = 0.f;
    for (int l = hi - 1; l >= lo; --l) {
      sum += v[l];
      v[l] = sum;
    }
    float incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);  // the runs after this lane's
    if (lane == 31) after = 0.f;
    for (int l = lo; l < hi; ++l) v[l] += after;
  }
  __syncthreads();
  const float Ah = a.A[h];
  const float* db = a.dt + b * a.dsb + row0 * a.dsl + h * a.dsh;
  float part = 0.f;
  for (int l = tid; l < Q; l += kThreads) {
    float* o = a.ddt + (static_cast<int64_t>(b) * a.L + row0 + l) * a.H + h;
    *o = fmaf(v[l], Ah, *o);
    part = fmaf(v[l], db[l * a.dsl], part);
  }
  // dA's partial for (b, c, h): the block's sum in a fixed order.
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    a.dA[bch] = s;
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int BC = a.B * a.C;
  const size_t s1 = 2 * static_cast<size_t>(kT) * kNS * 4;
  const size_t s2 = heads_smem_floats(a.Q) * 4;
  const size_t s3 = chunk_smem_floats(a.Q) * 4;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_scores<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s1))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_heads<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s2))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s3))) != cudaSuccess)
    return err;
  bwd_scores<T><<<BC * a.nT * a.nT, kThreads, s1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_heads<T><<<BC * a.NG * a.nT, kThreads, s2, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_chunk<T><<<2 * BC * a.nT + BC * a.H, kThreads, s3, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int64_t ssd_scan_bwd_scratch_floats(int B, int L, int H, int P, int N, int Q) {
  (void)P;
  if (B <= 0 || L <= 0 || H <= 0 || N <= 0 || Q <= 0 || L % Q != 0) return 0;
  return scratch_layout(B, L, H, N, Q).total;
}

extern "C" int ssd_scan_bwd_launch(const void* x, const float* dt, const float* A, const void* Bm,
                                   const void* Cm, const float* acs, const float* dy,
                                   const float* dst, const float* dain, void* dx, float* ddt,
                                   float* dA, void* dB, void* dC, float* scratch,
                                   int B, int L, int H, int P, int N, int Q,
                                   int64_t xsb, int64_t xsl, int64_t xsh,
                                   int64_t dsb, int64_t dsl, int64_t dsh,
                                   int64_t bsb, int64_t bsl, int64_t csb, int64_t csl,
                                   int64_t ysb, int64_t ysc, int64_t ysh, int64_t ysl,
                                   int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Q <= 0 || L % Q != 0 || Q % 2 != 0 || P <= 0 || P > kMaxP ||
      P % 4 != 0 ||
      N <= 0 || N > kMaxN || N % 4 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = L / Q, nT = (Q + kT - 1) / kT, NG = (H + kHG - 1) / kHG;
  const int64_t BC = static_cast<int64_t>(B) * C;
  if (BC * nT * nT > 0x7fffffff || BC * NG * nT > 0x7fffffff ||
      2 * BC * nT + BC * H > 0x7fffffff || heads_smem_floats(Q) * 4 > 232448 ||
      chunk_smem_floats(Q) * 4 > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  // x, B, C and dy are read 4 elements at a time.
  const int64_t vec = dtype == 1 ? 8 : 16;
  if (reinterpret_cast<uintptr_t>(x) % vec || reinterpret_cast<uintptr_t>(Bm) % vec ||
      reinterpret_cast<uintptr_t>(Cm) % vec || reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16 || xsb % 4 || xsl % 4 || xsh % 4 || bsb % 4 ||
      bsl % 4 || csb % 4 || csl % 4 || ysb % 4 || ysc % 4 || ysh % 4 || ysl % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_layout(B, L, H, N, Q);
  const Args a{x, dt, A, Bm, Cm, acs, dy, dst, dain, dx, ddt, dA, dB, dC,
               scratch + s.G, scratch + s.dGp, scratch + s.SBp, scratch + s.rowp,
               scratch + s.cpart, scratch + s.usum,
               B, L, H, P, N, Q, C, nT, NG,
               xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl, ysb, ysc, ysh, ysl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(a, st) : launch<__nv_bfloat16>(a, st);
  return static_cast<int>(err);
}
