// flash_attention_bwd: the gradient of flash_attention (causal or full GQA
// attention with an optional sliding window), written by hand for Hopper
// (sm_90a).
//
// The reference has no backward kernel: its Pallas kernel
// (repro/kernels/flash_attention.py::_flash_kernel) is forward only, and
// the JAX package differentiates the plain causal_attention /
// full_attention (repro/models/layers.py) with autodiff.  The port's
// forward on a card is the kernel, so its gradient is this kernel.  Given
// q, k, v, the forward's output o, its row log-sum-exp lse (natural log of
// the scaled scores, fp32 (B, H, S), from flash_attention.cu) and dO:
//
//     P  = exp(q k^T * scale - lse)          (recomputed, never stored)
//     dV = sum over the G query heads of P^T dO
//     dP = dO v^T,  Delta = rowsum(dO * o),  dS = P * (dP - Delta)
//     dQ = dS k * scale,  dK = sum over the G query heads of dS^T q * scale
//
// over the keys in range for each query (j <= i when causal, j > i - window
// with a window, j < S).  dq is (B, S, H, D), dk and dv (B, S, KV, D), all
// contiguous and in q's dtype.
//
// What bounds it: operations.  At olmo-1b's shape (B = 4, S = 2048, H = KV =
// 16, D = 128, bf16, causal) the five products it needs (S, dP, dV, dK, dQ)
// are 2.5 times the forward's 68.7 GFLOP = 171.8 GFLOP: 0.1737 ms at the
// H100's 989 TFLOP/s of bf16 tensor-core work, against about 0.2 GB of
// inputs and outputs (0.06 ms).  Three launches, in order, on the stream:
//   * bwd_delta: Delta = rowsum(dO * o) in fp32, one warp a row, (B, H, S).
//   * pass 1, dK and dV: one block per (b, KV head, 64-key tile); it keeps
//     its keys' dK and dV in registers and walks the G query heads and every
//     query tile the mask lets reach its keys, recomputing S^T and dP^T for
//     each.  Its outputs have one writer: no atomics, so the result is the
//     same run to run.
//   * pass 2, dQ: one block per (b, query head, 64-row query tile), walking
//     the key tiles in range as the forward does (it recomputes S and dP;
//     that recompute is not counted in the bound above).
// bf16: 4 warps a block, each on 16 rows (keys in pass 1, queries in pass
// 2), products on the tensor cores with mma.sync m16n8k16 and fp32
// accumulation.  A product's accumulator fragment is the A fragment of the
// next product (the m16n8 C layout of two neighbouring 8-column tiles is
// the m16k16 A layout), so P and dS never leave registers; they are rounded
// to bf16 there.  The B operands are read from shared memory as 32-bit
// pairs along their reduction axis, so the tiles a product reads along the
// other axis are kept twice, as loaded and transposed (q and dO in pass 1,
// k in pass 2).  Rows are padded by 8 elements so a warp's fragment loads
// hit distinct banks.  fp32: the same passes on the CUDA cores in fp32,
// 32-row tiles, 256 threads; for the fp32 configs the parity runs use.
// Tiles wholly outside the causal or window range are skipped (per block,
// and per warp for the 32-column halves of a tile).
// What holds it back now (a first kernel, right before fast): tile loads
// are synchronous (no cp.async or TMA ring), mma.sync rather than wgmma,
// the transposed copies are written with scalar stores, and pass 2
// recomputes S and dP.
//
// Interface: plain C, loaded with ctypes.  Returns cudaGetLastError() after
// the launches (0 = launched), or cudaErrorInvalidValue for arguments it does
// not take (for bf16 also bases or strides that are not multiples of 16
// bytes: it reads 16-byte vectors).  Launches on the given stream and does
// not synchronize; `delta` is the caller's (B, H, S) fp32 scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, KV;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, dsb, dss, dsh;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool allowed(int qpos, int kpos, const BwdArgs& a) {
  return qpos < a.S && kpos < a.S && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The first and one-past-last query tiles (of `tile` rows) whose queries can
// reach keys [k0, k0 + tile).
__device__ __forceinline__ void query_tiles(const BwdArgs& a, int k0, int tile, int* first,
                                            int* end) {
  const int n = (a.S + tile - 1) / tile;
  *first = a.causal ? k0 / tile : 0;
  *end = n;
  if (a.window > 0) *end = min(n, (k0 + tile - 1 + a.window - 1) / tile + 1);
}

// The first and one-past-last key tiles that queries [q0, q0 + tile) reach.
__device__ __forceinline__ void key_tiles(const BwdArgs& a, int q0, int tile, int* first,
                                          int* end) {
  const int q_last = min(q0 + tile, a.S) - 1;
  *end = (a.S + tile - 1) / tile;
  if (a.causal) *end = min(*end, q_last / tile + 1);
  *first = a.window > 0 ? max(0, q0 - a.window + 1) / tile : 0;
}

// ---------------------------------------------------------------------------
// Delta = rowsum(dO * o), fp32, (B, H, S): one warp a row.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_delta(BwdArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(a.B) * a.S * a.H) return;
  const int h = static_cast<int>(row % a.H);
  const int64_t bs = row / a.H;
  const int s = static_cast<int>(bs % a.S);
  const int b = static_cast<int>(bs / a.S);
  const T* orow = static_cast<const T*>(a.o) + b * a.osb + s * a.oss + h * a.osh;
  const T* drow = static_cast<const T*>(a.dout) + b * a.dsb + s * a.dss + h * a.dsh;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[(static_cast<int64_t>(b) * a.H + h) * a.S + s] = acc;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, 4 warps, 64-row tiles
// ---------------------------------------------------------------------------

constexpr int kBT = 64;           // rows of a tile: keys (pass 1) or queries (pass 2)
constexpr int kTS = kBT + 8;      // row stride of a transposed tile (elements)
constexpr int kBfThreads = 128;

template <int D>
constexpr int dkdv_bf16_smem() {  // K, V, Q, dO as loaded; Q^T, dO^T; lse, Delta
  return (4 * kBT * (D + 8) + 2 * D * kTS) * 2 + 2 * kBT * 4;
}
template <int D>
constexpr int dq_bf16_smem() {  // Q, dO, K, V as loaded; K^T
  return (4 * kBT * (D + 8) + D * kTS) * 2;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows r0 .. r0 + 63 of one head of a (B, S, heads, D) tensor (`base` at that
// batch and head, `rs` the row stride) into `nat` (rows of D + 8) and, if
// given, `tr` (D rows of kTS: column-major); rows past S are zeros.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* nat, __nv_bfloat16* tr,
                                               const __nv_bfloat16* base, int64_t rs, int r0,
                                               int S) {
  constexpr int V = D / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < kBT * V; i += blockDim.x) {
    const int r = i / V, c = (i % V) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(base + (r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(nat + r * (D + 8) + c) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c + j) * kTS + r] = e[j];
    }
  }
}

// The A fragment (16 rows from `row0`, k16 step from column `col0`) of a
// row-major tile with row stride `ld`.
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* t, int ld, int row0,
                                       int col0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  a[0] = ld32(t + (row0 + g) * ld + col0 + 2 * q);
  a[1] = ld32(t + (row0 + g + 8) * ld + col0 + 2 * q);
  a[2] = ld32(t + (row0 + g) * ld + col0 + 2 * q + 8);
  a[3] = ld32(t + (row0 + g + 8) * ld + col0 + 2 * q + 8);
}

// The B fragment (8 columns n0.., k16 step from k0) of a tile stored with
// the reduction axis contiguous: element (k, n) at t[n * ld + k].
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* t, int ld, int n0,
                                       int k0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const __nv_bfloat16* p = t + (n0 + g) * ld + k0 + 2 * q;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// Two neighbouring 16 x 8 accumulator tiles (32 columns = 4 tiles -> two
// k16 steps) as bf16 A fragments.
__device__ __forceinline__ void acc_to_a(uint32_t (*a)[4], const float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Pass 1: dK and dV of one 64-key tile of one KV head.  Warp w owns keys
// k0 + 16w .. + 15; per query tile it forms S^T and dP^T (16 keys x 32
// queries, twice) and accumulates dV += P^T dO, dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kBfThreads) bwd_dkdv_bf16(BwdArgs a) {
  constexpr int NS = D + 8;
  constexpr int ND = D / 8;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Vs = Ks + kBT * NS;
  __nv_bfloat16* Qs = Vs + kBT * NS;
  __nv_bfloat16* Os = Qs + kBT * NS;  // dO
  __nv_bfloat16* QT = Os + kBT * NS;
  __nv_bfloat16* OT = QT + D * kTS;
  float* lse_s = reinterpret_cast<float*>(OT + D * kTS);  // base 2
  float* dl_s = lse_s + kBT;

  const int b = blockIdx.x / a.KV;
  const int g = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const int k0 = blockIdx.y * kBT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int kw = 16 * warp;
  const float scale_log2 = a.scale * kLog2e;

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.ksb + g * a.ksh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.vsb + g * a.vsh;
  load_tile_bf16<D>(Ks, nullptr, kb, a.kss, k0, a.S);
  load_tile_bf16<D>(Vs, nullptr, vb, a.vss, k0, a.S);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int qt_first, qt_end;
  query_tiles(a, k0, kBT, &qt_first, &qt_end);
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
    const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dsb + h * a.dsh;
    const float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.S;
    const float* drow = a.delta + (static_cast<int64_t>(b) * a.H + h) * a.S;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kBT;
      __syncthreads();  // the previous tile's readers are done
      load_tile_bf16<D>(Qs, QT, qb, a.qss, q0, a.S);
      load_tile_bf16<D>(Os, OT, ob, a.dss, q0, a.S);
      for (int i = threadIdx.x; i < kBT; i += blockDim.x) {
        const bool in = q0 + i < a.S;
        lse_s[i] = in ? lrow[q0 + i] * kLog2e : 0.f;
        dl_s[i] = in ? drow[q0 + i] : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int cq = 0; cq < kBT; cq += 32) {
        const int qlo = q0 + cq, qhi = q0 + cq + 31;
        const int klo = k0 + kw, khi = k0 + kw + 15;
        if (qlo >= a.S || (a.causal && qhi < klo) || (a.window > 0 && qlo - a.window >= khi))
          continue;  // no pair of this warp's keys and these queries is in range
        float st[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t ak[4], av[4];
          frag_a(ak, Ks, NS, kw, 16 * ks);
          frag_a(av, Vs, NS, kw, 16 * ks);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            uint32_t bq[2], bo[2];
            frag_b(bq, Qs, NS, cq + 8 * n, 16 * ks);
            frag_b(bo, Os, NS, cq + 8 * n, 16 * ks);
            mma_bf16(st[n], ak, bq);
            mma_bf16(dp[n], av, bo);
          }
        }
        // st[n][e] is key kw + gr + 8 (e >> 1), query cq + 8n + 2t + (e & 1).
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = kw + gr + 8 * (e >> 1);
            const int ql = cq + 8 * n + 2 * t + (e & 1);
            float p = 0.f;
            if (allowed(q0 + ql, k0 + kl, a)) p = exp2f(fmaf(st[n][e], scale_log2, -lse_s[ql]));
            st[n][e] = p;
            dp[n][e] = p * (dp[n][e] - dl_s[ql]);
          }
        uint32_t pa[2][4], da[2][4];
        acc_to_a(pa, st);
        acc_to_a(da, dp);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            uint32_t bo[2], bq[2];
            frag_b(bo, OT, kTS, 8 * n, cq + 16 * kk);
            frag_b(bq, QT, kTS, 8 * n, cq + 16 * kk);
            mma_bf16(dv[n], pa[kk], bo);
            mma_bf16(dk[n], da[kk], bq);
          }
      }
    }
  }

  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kw + gr + 8 * half;
    if (key >= a.S) continue;
    const int64_t off = ((static_cast<int64_t>(b) * a.S + key) * a.KV + g) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + off + 8 * n) =
          pack_bf16(dk[n][2 * half] * a.scale, dk[n][2 * half + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + off + 8 * n) =
          pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// Pass 2: dQ of one 64-row query tile of one query head.  Warp w owns rows
// q0 + 16w .. + 15; per key tile it forms S and dP (16 rows x 32 keys,
// twice) and accumulates dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kBfThreads) bwd_dq_bf16(BwdArgs a) {
  constexpr int NS = D + 8;
  constexpr int ND = D / 8;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Os = Qs + kBT * NS;  // dO
  __nv_bfloat16* Ks = Os + kBT * NS;
  __nv_bfloat16* Vs = Ks + kBT * NS;
  __nv_bfloat16* KT = Vs + kBT * NS;

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int g = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBT;  // the longest causal rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int qw = 16 * warp;
  const float scale_log2 = a.scale * kLog2e;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dsb + h * a.dsh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.ksb + g * a.ksh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.vsb + g * a.vsh;
  load_tile_bf16<D>(Qs, nullptr, qb, a.qss, q0, a.S);
  load_tile_bf16<D>(Os, nullptr, ob, a.dss, q0, a.S);

  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qw + gr + 8 * half;
    const int64_t idx = (static_cast<int64_t>(b) * a.H + h) * a.S + row;
    lse2[half] = row < a.S ? a.lse[idx] * kLog2e : 0.f;
    dl[half] = row < a.S ? a.delta[idx] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int kt_first, kt_end;
  key_tiles(a, q0, kBT, &kt_first, &kt_end);
  for (int kt = kt_first; kt < kt_end; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();
    load_tile_bf16<D>(Ks, KT, kb, a.kss, k0, a.S);
    load_tile_bf16<D>(Vs, nullptr, vb, a.vss, k0, a.S);
    __syncthreads();
#pragma unroll 1
    for (int ck = 0; ck < kBT; ck += 32) {
      const int klo = k0 + ck, khi = k0 + ck + 31;
      const int qlo = q0 + qw, qhi = q0 + qw + 15;
      if (klo >= a.S || qlo >= a.S || (a.causal && klo > qhi) ||
          (a.window > 0 && khi <= qlo - a.window))
        continue;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t aq[4], ao[4];
        frag_a(aq, Qs, NS, qw, 16 * ks);
        frag_a(ao, Os, NS, qw, 16 * ks);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bk[2], bv[2];
          frag_b(bk, Ks, NS, ck + 8 * n, 16 * ks);
          frag_b(bv, Vs, NS, ck + 8 * n, 16 * ks);
          mma_bf16(s[n], aq, bk);
          mma_bf16(dp[n], ao, bv);
        }
      }
      // s[n][e] is query qw + gr + 8 (e >> 1), key ck + 8n + 2t + (e & 1).
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int qpos = q0 + qw + gr + 8 * half;
          const int kpos = k0 + ck + 8 * n + 2 * t + (e & 1);
          float p = 0.f;
          if (allowed(qpos, kpos, a)) p = exp2f(fmaf(s[n][e], scale_log2, -lse2[half]));
          dp[n][e] = p * (dp[n][e] - dl[half]);
        }
      uint32_t da[2][4];
      acc_to_a(da, dp);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bk[2];
          frag_b(bk, KT, kTS, 8 * n, ck + 16 * kk);
          mma_bf16(dq[n], da[kk], bk);
        }
    }
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qw + gr + 8 * half;
    if (row >= a.S) continue;
    const int64_t off = ((static_cast<int64_t>(b) * a.S + row) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqb + off + 8 * n) =
          pack_bf16(dq[n][2 * half] * a.scale, dq[n][2 * half + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// fp32: the same passes on the CUDA cores, 32-row tiles, 256 threads
// ---------------------------------------------------------------------------

constexpr int kFT = 32;
constexpr int kFThreads = 256;

template <int D>
constexpr int f32_smem() {  // four row tiles (rows of D + 1), P and dS (or dS alone), lse, Delta
  return (4 * kFT * (D + 1) + 2 * kFT * (kFT + 1) + 2 * kFT) * 4;
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base, int64_t rs, int r0,
                                              int S) {
  for (int i = threadIdx.x; i < kFT * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < S ? base[(r0 + r) * rs + d] : 0.f;
  }
}

// Entries e = tid + 256 r (r < 4) of a 32 x 32 (row, column) tile: the
// scores of `A` rows against `B` rows, and of `C` rows against `E` rows.
template <int D>
__device__ __forceinline__ void dots(const float* A, const float* Bm, const float* C,
                                     const float* E, int e, float* s, float* dp) {
  const int r = e / kFT, c = e % kFT;
  float x = 0.f, y = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    x = fmaf(A[r * (D + 1) + d], Bm[c * (D + 1) + d], x);
    y = fmaf(C[r * (D + 1) + d], E[c * (D + 1) + d], y);
  }
  *s = x;
  *dp = y;
}

template <int D>
__global__ void __launch_bounds__(kFThreads) bwd_dkdv_f32(BwdArgs a) {
  constexpr int DS = D + 1, PS = kFT + 1, NJ = D / 8;
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + kFT * DS;
  float* Qs = Vs + kFT * DS;
  float* Os = Qs + kFT * DS;
  float* Ps = Os + kFT * DS;
  float* dSs = Ps + kFT * PS;
  float* lse_s = dSs + kFT * PS;
  float* dl_s = lse_s + kFT;

  const int b = blockIdx.x / a.KV;
  const int g = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const int k0 = blockIdx.y * kFT;
  const int key = threadIdx.x / 8, c8 = threadIdx.x % 8;

  load_tile_f32<D>(Ks, static_cast<const float*>(a.k) + b * a.ksb + g * a.ksh, a.kss, k0, a.S);
  load_tile_f32<D>(Vs, static_cast<const float*>(a.v) + b * a.vsb + g * a.vsh, a.vss, k0, a.S);
  float dk[NJ], dv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dk[j] = dv[j] = 0.f;

  int qt_first, qt_end;
  query_tiles(a, k0, kFT, &qt_first, &qt_end);
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.S;
    const float* drow = a.delta + (static_cast<int64_t>(b) * a.H + h) * a.S;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kFT;
      __syncthreads();
      load_tile_f32<D>(Qs, static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh, a.qss, q0, a.S);
      load_tile_f32<D>(Os, static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh, a.dss, q0,
                       a.S);
      for (int i = threadIdx.x; i < kFT; i += blockDim.x) {
        const bool in = q0 + i < a.S;
        lse_s[i] = in ? lrow[q0 + i] : 0.f;
        dl_s[i] = in ? drow[q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = threadIdx.x + kFThreads * r;
        const int ql = e / kFT, kl = e % kFT;
        float s, dp;
        dots<D>(Qs, Ks, Os, Vs, e, &s, &dp);
        const float p = allowed(q0 + ql, k0 + kl, a) ? expf(s * a.scale - lse_s[ql]) : 0.f;
        Ps[ql * PS + kl] = p;
        dSs[ql * PS + kl] = p * (dp - dl_s[ql]);
      }
      __syncthreads();
      for (int ql = 0; ql < kFT; ++ql) {
        const float p = Ps[ql * PS + key], ds = dSs[ql * PS + key];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv[j] = fmaf(p, Os[ql * DS + c8 + 8 * j], dv[j]);
          dk[j] = fmaf(ds, Qs[ql * DS + c8 + 8 * j], dk[j]);
        }
      }
    }
  }
  if (k0 + key < a.S) {
    const int64_t off = ((static_cast<int64_t>(b) * a.S + k0 + key) * a.KV + g) * D + c8;
    float* dkb = static_cast<float*>(a.dk);
    float* dvb = static_cast<float*>(a.dv);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkb[off + 8 * j] = dk[j] * a.scale;
      dvb[off + 8 * j] = dv[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads) bwd_dq_f32(BwdArgs a) {
  constexpr int DS = D + 1, PS = kFT + 1, NJ = D / 8;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Os = Qs + kFT * DS;
  float* Ks = Os + kFT * DS;
  float* Vs = Ks + kFT * DS;
  float* dSs = Vs + kFT * DS;
  float* lse_s = dSs + 2 * kFT * PS;
  float* dl_s = lse_s + kFT;

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int g = h / (a.H / a.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFT;
  const int row = threadIdx.x / 8, c8 = threadIdx.x % 8;

  load_tile_f32<D>(Qs, static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh, a.qss, q0, a.S);
  load_tile_f32<D>(Os, static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh, a.dss, q0, a.S);
  for (int i = threadIdx.x; i < kFT; i += blockDim.x) {
    const int64_t idx = (static_cast<int64_t>(b) * a.H + h) * a.S + q0 + i;
    const bool in = q0 + i < a.S;
    lse_s[i] = in ? a.lse[idx] : 0.f;
    dl_s[i] = in ? a.delta[idx] : 0.f;
  }
  float dq[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dq[j] = 0.f;

  int kt_first, kt_end;
  key_tiles(a, q0, kFT, &kt_first, &kt_end);
  for (int kt = kt_first; kt < kt_end; ++kt) {
    const int k0 = kt * kFT;
    __syncthreads();
    load_tile_f32<D>(Ks, static_cast<const float*>(a.k) + b * a.ksb + g * a.ksh, a.kss, k0, a.S);
    load_tile_f32<D>(Vs, static_cast<const float*>(a.v) + b * a.vsb + g * a.vsh, a.vss, k0, a.S);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = threadIdx.x + kFThreads * r;
      const int ql = e / kFT, kl = e % kFT;
      float s, dp;
      dots<D>(Qs, Ks, Os, Vs, e, &s, &dp);
      const float p = allowed(q0 + ql, k0 + kl, a) ? expf(s * a.scale - lse_s[ql]) : 0.f;
      dSs[ql * PS + kl] = p * (dp - dl_s[ql]);
    }
    __syncthreads();
    for (int kl = 0; kl < kFT; ++kl) {
      const float ds = dSs[row * PS + kl];
#pragma unroll
      for (int j = 0; j < NJ; ++j) dq[j] = fmaf(ds, Ks[kl * DS + c8 + 8 * j], dq[j]);
    }
  }
  if (q0 + row < a.S) {
    float* dqb = static_cast<float*>(a.dq);
    const int64_t off = ((static_cast<int64_t>(b) * a.S + q0 + row) * a.H + h) * D + c8;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqb[off + 8 * j] = dq[j] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t run(K kernel, dim3 grid, int threads, int smem, cudaStream_t st, const BwdArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const BwdArgs& a, bool bf16, cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(a.B) * a.S * a.H;
  const dim3 dgrid(static_cast<unsigned>((rows + 7) / 8));
  cudaError_t err = bf16 ? run(bwd_delta<__nv_bfloat16, D>, dgrid, 256, 0, st, a)
                         : run(bwd_delta<float, D>, dgrid, 256, 0, st, a);
  if (err != cudaSuccess) return err;
  if (bf16) {
    err = run(bwd_dkdv_bf16<D>, dim3(a.B * a.KV, (a.S + kBT - 1) / kBT), kBfThreads,
              dkdv_bf16_smem<D>(), st, a);
    if (err != cudaSuccess) return err;
    return run(bwd_dq_bf16<D>, dim3(a.B * a.H, (a.S + kBT - 1) / kBT), kBfThreads,
               dq_bf16_smem<D>(), st, a);
  }
  err = run(bwd_dkdv_f32<D>, dim3(a.B * a.KV, (a.S + kFT - 1) / kFT), kFThreads, f32_smem<D>(),
            st, a);
  if (err != cudaSuccess) return err;
  return run(bwd_dq_f32<D>, dim3(a.B * a.H, (a.S + kFT - 1) / kFT), kFThreads, f32_smem<D>(), st,
             a);
}

bool vec_ok(const void* p, int64_t s0, int64_t s1, int64_t s2) {  // 16-byte bf16 vectors
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 && s1 % 8 == 0 && s2 % 8 == 0;
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv,
    int B, int S, int H, int KV, int D,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh,
    int64_t dsb, int64_t dss, int64_t dsh,
    int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      static_cast<int64_t>(B) * H > 0x7fffffff || (S + kFT - 1) / kFT > 65535 ||
      (dtype != 0 && dtype != 1) || (D != 64 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == 1;
  if (bf16 && (!vec_ok(q, qsb, qss, qsh) || !vec_ok(k, ksb, kss, ksh) || !vec_ok(v, vsb, vss, vsh) ||
               !vec_ok(o, osb, oss, osh) || !vec_ok(dout, dsb, dss, dsh) ||
               reinterpret_cast<uintptr_t>(dq) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(dk) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(dv) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{q,   k,   v,   o,   dout, lse, delta, dq,  dk,  dv,  B,      S,     H,
                  KV,  qsb, qss, qsh, ksb,  kss, ksh,   vsb, vss, vsh, osb,    oss,   osh,
                  dsb, dss, dsh, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D == 64 ? launch<64>(a, bf16, st) : launch<128>(a, bf16, st));
}
