// ssd_chunk_scan: the intra-chunk part of Mamba-2's SSD (state-space
// duality) scan, written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py::_ssd_kernel, the Pallas TPU kernel.
// For each batch b, chunk c of Q positions and head h it computes, in fp32:
//
//     a_cs[l]   = sum_{t <= l} dt[t] * A[h]                       (Q,)
//     y[l, p]   = sum_{s <= l} exp(a_cs[l] - a_cs[s]) (C[l] . B[s]) dt[s] x[s, p]
//     st[p, n]  = sum_s B[s, n] dt[s] x[s, p] exp(a_cs[Q-1] - a_cs[s])
//
// with x (B, L, H, P), dt (B, L, H) fp32, A (H,) fp32, B and C (B, L, N);
// x, B and C fp32 or bf16.  Outputs y (B, C, H, Q, P), st (B, C, H, P, N)
// and a_cs (B, C, H, Q), all fp32, as the Pallas kernel writes them.  The
// inter-chunk recurrence and the carried-state term stay torch ops in the
// wrapper, as they stay XLA ops in the reference.
//
// exp(a_cs[l] - a_cs[s]) is formed only where s <= l: above the diagonal
// the difference is positive and large, the exponential overflows, and
// inf * 0 would give NaN (the reference masks the argument for the same
// reason).
//
// What bounds it: at mamba2-130m's prefill (B = 4, L = 2048, H = 24, P =
// 64, N = 128, Q = 256) the arithmetic the function needs, counted where
// the decay is not zero (s <= l), is about 6.72 GFLOP: y Q*(Q+1)*P and st
// 2*P*N*Q per (b, c, h), 3.23 and 3.22 GFLOP, and the scores C . B^T,
// Q*(Q+1)*N once per (b, c), 0.27 GFLOP.  At 67 TFLOP/s of fp32 that is
// 0.100 ms, against about 106 MB moved, 0.032 ms: operations.  The scores
// are 4 % of it whatever unit computes them, so the bound stays the fp32
// one also where they run on the tensor cores.
//
// The design, one launch of two kinds of blocks, 256 threads each:
//   * y blocks, one per (b, c, 64-row l-tile, group of 4 heads): 768 at
//     mamba2-130m's prefill.  The block forms each 64 x 64 score tile
//     (l-tile, s-tile <= l-tile) once, keeps it in shared memory, and all 4
//     heads multiply it into their 64 x P output tiles, held in registers
//     across the s-tiles.  Off the diagonal the decay factors through the
//     position before the l-tile (see y_block), so the score tile is the
//     products' left operand as it is and x's rows carry dt and the decay
//     to that position, two heads a pass; on the diagonal each head forms
//     its weights (the decay exp(a_cs[l] - a_cs[s]) and dt[s], zero above
//     the diagonal) in shared memory.  A head's 64 x P tile belongs to 64
//     threads.  The TPU kernel shares the scores across a block of 8 heads;
//     4 keeps the 4 output tiles in registers and two blocks on an SM.  For bf16 B and C the scores are mma.sync
//     m16n8k16 with fp32 accumulation (the product of two bf16 values is
//     exact in fp32, so only the order of summation differs from the
//     reference's fp32 product); for fp32 B and C, fp32 FMAs.  Each block
//     computes its heads' a_cs up to its l-tile (a warp's scan in shared
//     memory) and writes the l-tile's part.
//   * state blocks, one per (b, c, pair of heads): 384 at that shape.
//     x dt exp(a_cs[Q-1] - a_cs[s]) of both heads is formed tile by tile in
//     shared memory beside the B tile they share and multiplied into the
//     P x N states held in registers, 128 threads a head.
//   * Blocks are issued heaviest first: the state blocks (a whole chunk of
//     work), then the y blocks, latest l-tile first.  Every output element has
//     exactly one writer and no atomics are used, so results do not change
//     from run to run.
//   * y and the states stay fp32 on the CUDA cores: their operands, the
//     weights and x dt, are fp32, and the kernel-alone checks hold them at
//     2e-5 of the output's scale.  Each thread owns 8 x 8 of an output tile
//     or a state (fma8x8) and reads shared memory as float4 (rows padded by
//     4 floats), four vectors for 64 FMAs.
//   * A ragged chunk (Q not a multiple of 64) is masked here.
// What holds it back now (inferred; no profiler counters on the card): the
// fp32 products run on the CUDA cores at a fifteenth of the tensor cores'
// rate, the diagonal tiles still form weights per head and element (an exp
// each), and every tile costs barriers among 8 warps with loads that are
// not overlapped with the products.  Moving y and the
// states to the tensor cores (3xTF32, say) needs a decision on precision
// and on the bound first.
//
// Limits, checked on the host: P <= 64, N <= 128, both multiples of 4, Q
// even; x, B and C with bases and strides that allow reads of 4 elements
// (the wrapper copies a tensor otherwise).
//
// Interface: plain C, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for arguments it does
// not take.  Launches on the given stream and does not synchronize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;           // positions per tile
constexpr int kG = 4;            // heads per y block, sharing the scores
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kNS = kMaxN + 4;   // row stride of fp32 B and C tiles (floats)
constexpr int kNSb = kMaxN + 8;  // row stride of bf16 B and C tiles (elements)
constexpr int kXS = kMaxP + 4;   // row stride of the x tile
constexpr int kWS = kT + 4;      // row stride of the score and weight tiles

// Shared memory, in bytes from the start: a_cs and dt of up to kG heads
// (Q floats each), the C tile (a state block's B tile), the score tile,
// and a region of two square tiles that holds the B tile while the scores
// are formed and the heads' x and weight rows after (a state block's two
// heads' weighted x).
constexpr int kTileF = kT * kNS * 4;   // an fp32 B or C tile
constexpr int kSqF = kT * kWS * 4;     // a 64 x 64 score, weight or x tile

size_t smem_bytes(int Q) {
  return static_cast<size_t>(8) * kG * Q + kTileF + kSqF + 2 * kSqF;
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  float* y;
  float* st;
  float* acs;
  int B, L, H, P, N, Q, C;
  int64_t xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl;
};

// Four consecutive elements as floats: 16 bytes of fp32 or 8 of bf16 (the
// host checks that rows and bases allow it).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Rows [s0, s0 + rows) of an (L, width) slab (row stride `ls`, width a
// multiple of 4, at most 4 * LPR) into an fp32 tile of row stride `ts`, a
// float4 a thread, LPR threads a row; rows past Q are zero, and each row s
// is scaled by f[s] when f is given.
template <int LPR, typename T>
__device__ __forceinline__ void load_rows(float* tile, int ts, const T* base, int64_t ls, int s0,
                                          int rows, int Q, int width, const float* f) {
  const int v = threadIdx.x % LPR;
  if (4 * v >= width) return;
  for (int r = threadIdx.x / LPR; r < rows; r += kThreads / LPR) {
    const int s = s0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < Q) {
      val = load4(base + s * ls + 4 * v);
      if (f != nullptr) {
        const float m = f[s];
        val.x *= m;
        val.y *= m;
        val.z *= m;
        val.w *= m;
      }
    }
    *reinterpret_cast<float4*>(&tile[r * ts + 4 * v]) = val;
  }
}

// The same rows of a bf16 (L, N) slab kept in bf16, 8 bytes a thread,
// columns zero from N up to a multiple of 16 (the mma's k step).
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                               int64_t ls, int s0, int Q, int N) {
  const int v = threadIdx.x & 31;
  if (4 * v >= ((N + 15) & ~15)) return;
  for (int r = threadIdx.x >> 5; r < kT; r += kThreads / 32) {
    const int s = s0 + r;
    uint2 u = make_uint2(0u, 0u);
    if (s < Q && 4 * v < N) u = *reinterpret_cast<const uint2*>(base + s * ls + 4 * v);
    *reinterpret_cast<uint2*>(&tile[r * kNSb + 4 * v]) = u;
  }
}

// a_cs[i] = sum_{t <= i} dt[t] * Ah for i < n: one warp, a run of
// positions per lane, a shuffle scan over the runs' totals.
__device__ __forceinline__ void warp_cumsum(float* acs, const float* dts, int n, float Ah,
                                            int lane) {
  const int run = (n + 31) / 32;
  const int lo = min(lane * run, n), hi = min(lo + run, n);
  float sum = 0.f;
  for (int i = lo; i < hi; ++i) {
    sum += dts[i] * Ah;
    acs[i] = sum;
  }
  float incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);  // the runs before this lane's
  if (lane == 0) before = 0.f;
  for (int i = lo; i < hi; ++i) acs[i] += before;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The 64 x 64 score tile C[l] . B[s] into St[s * kWS + l] (transposed, so
// a head's weights are formed elementwise from it).  bf16: each warp forms
// 16 rows x 32 columns with mma.sync; fp32: each thread 4 x 4 by FMAs.
__device__ __forceinline__ void scores(float* St, const __nv_bfloat16* Cb, const __nv_bfloat16* Bb,
                                       int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mr = 16 * (warp & 3), nc = 32 * (warp >> 2);
  float c[4][4] = {};
  for (int k = 0; k < N; k += 16) {
    uint32_t a[4];
    a[0] = ld32(&Cb[(mr + g) * kNSb + k + 2 * t]);
    a[1] = ld32(&Cb[(mr + g + 8) * kNSb + k + 2 * t]);
    a[2] = ld32(&Cb[(mr + g) * kNSb + k + 8 + 2 * t]);
    a[3] = ld32(&Cb[(mr + g + 8) * kNSb + k + 8 + 2 * t]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* brow = &Bb[(nc + 8 * j + g) * kNSb + k + 2 * t];
      const uint32_t bf[2] = {ld32(brow), ld32(brow + 8)};
      mma_bf16(c[j], a, bf);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = mr + g + 8 * (e >> 1), s = nc + 8 * j + 2 * t + (e & 1);
      St[s * kWS + l] = c[j][e];
    }
}

__device__ __forceinline__ void scores(float* St, const float* Cf, const float* Bf, int N) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // rows 4ty + i, columns tx + 16j
  float sc[4][4] = {};
  for (int n = 0; n < N; n += 4) {
    float4 cf[4], bf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cf[i] = *reinterpret_cast<const float4*>(&Cf[(4 * ty + i) * kNS + n]);
#pragma unroll
    for (int j = 0; j < 4; ++j) bf[j] = *reinterpret_cast<const float4*>(&Bf[(tx + 16 * j) * kNS + n]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = sc[i][j];
        s = fmaf(cf[i].x, bf[j].x, s);
        s = fmaf(cf[i].y, bf[j].y, s);
        s = fmaf(cf[i].z, bf[j].z, s);
        s = fmaf(cf[i].w, bf[j].w, s);
        sc[i][j] = s;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) St[(tx + 16 * j) * kWS + 4 * ty + i] = sc[i][j];
}

// Loads of a B or C tile in the form `scores` takes for each dtype.
__device__ __forceinline__ void load_bc(float* tile, const float* base, int64_t ls, int s0, int Q,
                                        int N) {
  load_rows<32>(tile, kNS, base, ls, s0, kT, Q, N, static_cast<const float*>(nullptr));
}
__device__ __forceinline__ void load_bc(__nv_bfloat16* tile, const __nv_bfloat16* base, int64_t ls,
                                        int s0, int Q, int N) {
  load_tile_bf16(tile, base, ls, s0, Q, N);
}

// Rows [s0, s0 + rows) of x for `heads` heads (head hl at base + hl * hs),
// row s of head hl scaled by f[hl * Q + s] when f is given, into fp32
// tiles of `rows` rows of stride kXS, one per head; zero for heads past nh.
template <typename T>
__device__ __forceinline__ void load_x(float* tile, const T* base, int64_t hs, int64_t ls, int s0,
                                       int rows, int heads, int nh, int Q, int P, const float* f) {
  for (int hl = 0; hl < heads; ++hl) {
    load_rows<16>(tile + hl * rows * kXS, kXS, base + hl * hs, ls, s0, rows, hl < nh ? Q : 0, P,
                  f == nullptr ? f : f + hl * Q);
  }
}

// acc[ri][i][ci][j] += sum_r A[r][AO * ri + 4 rg + i] X[r][XO * ci + 4 cg + j]
// over `rows` rows: a thread's 8 x 8 tile, read from shared memory as
// float4 (the 8 threads of a quarter-warp read consecutive A vectors and
// one X vector).
template <int AS, int AO, int XS, int XO>
__device__ __forceinline__ void fma8x8(float (&acc)[2][4][2][4], const float* A, const float* X,
                                       int rows, int rg, int cg) {
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    float w[2][4], x[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&A[r * AS + AO * k + 4 * rg]);
      const float4 xv = *reinterpret_cast<const float4*>(&X[r * XS + XO * k + 4 * cg]);
      w[k][0] = av.x; w[k][1] = av.y; w[k][2] = av.z; w[k][3] = av.w;
      x[k][0] = xv.x; x[k][1] = xv.y; x[k][2] = xv.z; x[k][3] = xv.w;
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int ci = 0; ci < 2; ++ci)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[ri][i][ci][j] = fmaf(w[ri][i], x[ci][j], acc[ri][i][ci][j]);
  }
}

// y for (b, c, l-tile lt, heads h0 .. h0 + nh - 1).  Thread tid works on
// head tid / 64 of the group: rows 4 rg + i and 32 + 4 rg + i, columns
// 4 cg + j and 32 + 4 cg + j of its 64 x P output tile.
//
// Off the diagonal (s-tiles before the l-tile) the decay factors through
// the position just before the l-tile, r = l0 - 1:
//     exp(a[l] - a[s]) = exp(a[l] - a[r]) * exp(a[r] - a[s]),
// both factors <= 1 (a_cs falls along the chunk), so neither overflows.
// The second goes with dt[s] into x's rows, and the score tile itself is
// the products' left operand, shared by the group's heads; the first
// scales the output rows once, before the diagonal tile.  On the diagonal
// the weights are formed per head and element, zero above it, as in the
// reference.
template <typename T>
__device__ __forceinline__ void y_block(const Args& a, uint8_t* smem, int b, int c, int lt, int h0) {
  float* acs = reinterpret_cast<float*>(smem);         // [kG][Q]
  float* dts = acs + kG * a.Q;                         // [kG][Q]
  T* Ct = reinterpret_cast<T*>(dts + kG * a.Q);        // the C tile
  float* St = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(Ct) + kTileF);  // scores [s][l]
  T* Bt = reinterpret_cast<T*>(St + kT * kWS);         // the B tile, then
  float* U = reinterpret_cast<float*>(Bt);             // x tiles (and weights) of the heads

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hl = tid >> 6, rg = tid & 7, cg = (tid >> 3) & 7;
  const int Q = a.Q, P = a.P, N = a.N;
  const int nh = min(kG, a.H - h0);
  const int l0 = lt * kT;
  const int l_end = min(l0 + kT, Q);
  const int64_t row0 = static_cast<int64_t>(c) * Q;

  const T* xb = static_cast<const T*>(a.x) + b * a.xsb + row0 * a.xsl + h0 * a.xsh;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bsb + row0 * a.bsl;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.csb + row0 * a.csl;
  const float* db = a.dt + b * a.dsb + row0 * a.dsl + h0 * a.dsh;

  // a_cs of the group's heads up to the l-tile's end; the l-tile's part is
  // this block's to write.  Then dt[s] for s < l0 becomes
  // dt[s] exp(a[l0 - 1] - a[s]), the off-diagonal row factor of x.
  for (int i = tid; i < nh * l_end; i += kThreads) {
    const int h = i / l_end, s = i % l_end;
    dts[h * Q + s] = db[s * a.dsl + h * a.dsh];
  }
  __syncthreads();
  if (warp < nh) warp_cumsum(acs + warp * Q, dts + warp * Q, l_end, a.A[h0 + warp], lane);
  __syncthreads();
  for (int i = tid; i < nh * (l_end - l0); i += kThreads) {
    const int h = i / (l_end - l0), l = l0 + i % (l_end - l0);
    a.acs[((static_cast<int64_t>(b) * a.C + c) * a.H + h0 + h) * Q + l] = acs[h * Q + l];
  }
  for (int i = tid; i < nh * l0; i += kThreads) {
    const int h = i / l0, s = i % l0;
    dts[h * Q + s] *= expf(acs[h * Q + l0 - 1] - acs[h * Q + s]);
  }
  load_bc(Ct, Cb, a.csl, l0, Q, N);

  float acc[2][4][2][4];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int ci = 0; ci < 2; ++ci)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ri][i][ci][j] = 0.f;

  for (int st = 0; st <= lt; ++st) {
    const int s0 = st * kT;
    __syncthreads();  // the last s-tile's readers of U are done
    load_bc(Bt, Bb, a.bsl, s0, Q, N);
    __syncthreads();
    scores(St, Ct, Bt, N);
    __syncthreads();  // St is formed; Bt's space goes to the x tiles

    if (st < lt) {
      // Off the diagonal: acc += St^T (x dt exp(a[r] - a[s])) for every head
      // at once, in two halves of 32 positions (the 4 heads' x rows fill U).
      for (int half = 0; half < 2; ++half) {
        if (half > 0) __syncthreads();
        load_x(U, xb, a.xsh, a.xsl, s0 + 32 * half, 32, kG, nh, Q, P, dts);
        __syncthreads();
        fma8x8<kWS, 32, kXS, 32>(acc, St + 32 * half * kWS, U + hl * 32 * kXS, 32, rg, cg);
      }
      continue;
    }

    // The diagonal tile.  First the off-diagonal sums get their row factor
    // exp(a[l] - a[l0 - 1]).
    if (lt > 0 && hl < nh) {
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + 32 * ri + 4 * rg + i;
          const float e = l < l_end ? expf(acs[hl * Q + l] - acs[hl * Q + l0 - 1]) : 0.f;
#pragma unroll
          for (int ci = 0; ci < 2; ++ci)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[ri][i][ci][j] *= e;
        }
    }
    // Then four quarters of 16 positions: the heads' weights [s][l] and x
    // rows, side by side in U.
    float* W = U;
    float* X = U + kG * 16 * kWS;
    for (int qt = 0; qt < 4; ++qt) {
      if (qt > 0) __syncthreads();
      for (int i = tid; i < kG * 16 * kT; i += kThreads) {
        const int l = i % kT, s = (i / kT) % 16, h = i / (16 * kT);
        const int sp = s0 + 16 * qt + s, lp = l0 + l;
        W[(h * 16 + s) * kWS + l] =
            h < nh && sp <= lp && lp < Q
                ? St[(16 * qt + s) * kWS + l] * expf(acs[h * Q + lp] - acs[h * Q + sp]) * dts[h * Q + sp]
                : 0.f;
      }
      load_x(X, xb, a.xsh, a.xsl, s0 + 16 * qt, 16, kG, nh, Q, P, static_cast<const float*>(nullptr));
      __syncthreads();
      fma8x8<kWS, 32, kXS, 32>(acc, W + hl * 16 * kWS, X + hl * 16 * kXS, 16, rg, cg);
    }
  }

  if (hl < nh) {
    float* yb = a.y + (((static_cast<int64_t>(b) * a.C + c) * a.H + h0 + hl) * Q) * P;
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + 32 * ri + 4 * rg + i;
        if (l >= Q) continue;
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          const int p = 32 * ci + 4 * cg;
          if (p < P)
            *reinterpret_cast<float4*>(&yb[static_cast<int64_t>(l) * P + p]) = make_float4(
                acc[ri][i][ci][0], acc[ri][i][ci][1], acc[ri][i][ci][2], acc[ri][i][ci][3]);
        }
      }
  }
}

// The chunk states of (b, c, heads h0, h0 + 1): st[p, n] = sum_s (x dt
// decay)[s, p] B[s, n], with dt[s] exp(a[Q-1] - a[s]) formed once per
// position and the B tile shared by the two heads.  Thread tid works on
// head tid / 128: rows 4 pg + i and 32 + 4 pg + i, columns 4 ng + j and
// 64 + 4 ng + j of its P x N state.
template <typename T>
__device__ __forceinline__ void state_block(const Args& a, uint8_t* smem, int b, int c, int h0) {
  float* acs = reinterpret_cast<float*>(smem);   // [2][Q], at the y blocks' offsets
  float* dts = acs + kG * a.Q;                   // [2][Q]
  float* Bs = dts + kG * a.Q;
  float* Ws = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(Bs) + kTileF + kSqF);  // [2][64][kXS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hl = tid >> 7, pg = tid & 7, ng = (tid >> 3) & 15;
  const int Q = a.Q, P = a.P, N = a.N;
  const int nh = min(2, a.H - h0);
  const int64_t row0 = static_cast<int64_t>(c) * Q;
  const T* xb = static_cast<const T*>(a.x) + b * a.xsb + row0 * a.xsl + h0 * a.xsh;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bsb + row0 * a.bsl;
  const float* db = a.dt + b * a.dsb + row0 * a.dsl + h0 * a.dsh;

  for (int i = tid; i < nh * Q; i += kThreads) {
    const int h = i / Q, s = i % Q;
    dts[h * Q + s] = db[s * a.dsl + h * a.dsh];
  }
  __syncthreads();
  if (warp < nh) warp_cumsum(acs + warp * Q, dts + warp * Q, Q, a.A[h0 + warp], lane);
  __syncthreads();
  for (int i = tid; i < nh * Q; i += kThreads) {
    const int h = i / Q, s = i % Q;
    dts[h * Q + s] *= expf(acs[h * Q + Q - 1] - acs[h * Q + s]);
  }

  float acc[2][4][2][4];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int ci = 0; ci < 2; ++ci)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ri][i][ci][j] = 0.f;
  for (int s0 = 0; s0 < Q; s0 += kT) {
    __syncthreads();  // the factors are formed; the last tile's readers are done
    load_rows<32>(Bs, kNS, Bb, a.bsl, s0, kT, Q, N, static_cast<const float*>(nullptr));
    load_x(Ws, xb, a.xsh, a.xsl, s0, kT, 2, nh, Q, P, dts);
    __syncthreads();
    fma8x8<kXS, 32, kNS, 64>(acc, Ws + hl * kT * kXS, Bs, kT, pg, ng);
  }
  if (hl < nh) {
    float* stb = a.st + ((static_cast<int64_t>(b) * a.C + c) * a.H + h0 + hl) * P * N;
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 32 * ri + 4 * pg + i;
        if (p >= P) continue;
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          const int n = 64 * ci + 4 * ng;
          if (n < N)
            *reinterpret_cast<float4*>(&stb[static_cast<int64_t>(p) * N + n]) = make_float4(
                acc[ri][i][ci][0], acc[ri][i][ci][1], acc[ri][i][ci][2], acc[ri][i][ci][3]);
        }
      }
  }
}

// Blocks in issue order, heaviest first: the state blocks (a whole chunk
// of work for two heads), then the y blocks, latest l-tile first.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_intra(Args a) {
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int n_tiles = (a.Q + kT - 1) / kT;
  const int pairs = (a.H + 1) / 2;
  const int groups = (a.H + kG - 1) / kG;
  const int n_states = a.B * a.C * pairs;
  int i = blockIdx.x;
  if (i < n_states) {
    const int bc = i / pairs;
    state_block<T>(a, smem, bc / a.C, bc % a.C, 2 * (i % pairs));
    return;
  }
  i -= n_states;
  const int per_lt = a.B * a.C * groups;
  const int lt = n_tiles - 1 - i / per_lt;
  const int r = i % per_lt;
  const int bc = r / groups;
  y_block<T>(a, smem, bc / a.C, bc % a.C, lt, (r % groups) * kG);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.Q + kT - 1) / kT;
  const int64_t blocks = static_cast<int64_t>(a.B) * a.C *
                         ((a.H + 1) / 2 + static_cast<int64_t>(n_tiles) * ((a.H + kG - 1) / kG));
  ssd_intra<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A, const void* Bm,
                               const void* Cm, float* y, float* st, float* acs,
                               int B, int L, int H, int P, int N, int Q,
                               int64_t xsb, int64_t xsl, int64_t xsh,
                               int64_t dsb, int64_t dsl, int64_t dsh,
                               int64_t bsb, int64_t bsl, int64_t csb, int64_t csl,
                               int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Q <= 0 || L % Q != 0 || Q % 2 != 0 ||
      P <= 0 || P > kMaxP || P % 4 != 0 || N <= 0 || N > kMaxN || N % 4 != 0 ||
      static_cast<int64_t>(B) * (L / Q) * ((Q + kT - 1) / kT + 1) * H > 0x7fffffff ||
      smem_bytes(Q) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // x, B and C are read 4 elements at a time.
  const int64_t vec = dtype == 1 ? 8 : 16;
  if (reinterpret_cast<uintptr_t>(x) % vec || reinterpret_cast<uintptr_t>(Bm) % vec ||
      reinterpret_cast<uintptr_t>(Cm) % vec || xsb % 4 || xsl % 4 || xsh % 4 || bsb % 4 ||
      bsl % 4 || csb % 4 || csl % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, dt, A, Bm, Cm, y, st, acs, B, L, H, P, N, Q, L / Q,
               xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(a, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(a, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
