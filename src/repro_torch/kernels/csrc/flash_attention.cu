// flash_attention: causal or full GQA attention, forward only, with an
// optional sliding window, written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel, the Pallas TPU
// kernel.  It computes the same function:
//
//     o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,g,:] / sqrt(D)) v[b,j,g,:]
//
// over the keys j in range for query i (j <= i when causal, j > i - window
// with a window), with g = h / (H / KV) the KV head that query head h
// reads.  q, k, v are fp32 or bf16; the output is in q's dtype.  Rows with
// no key in range give 0 (the Pallas kernel's l == 0 guard).
//
// Layout: the reference's (B, S, heads, D) with any strides over the first
// three axes and D contiguous, so the wrapper passes the projections as
// they come, without a transpose or a padded copy.
//
// What bounds it: operations.  At olmo-1b's prefill (B = 4, S = 2048, H =
// KV = 16, D = 128, bf16, causal) the two products are 2*B*H*S^2*D = 68.7
// GFLOP against 134 MB of q, k, v and o: 0.0695 ms at the H100's 989
// TFLOP/s of bf16 tensor-core work, 0.040 ms of device-memory bytes.  So
// the products belong on the tensor cores.  Two paths, one per dtype:
//   * bf16 (the models' dtype, the main path): flash_fwd_mma, four warps
//     a block on mma.sync m16n8k16 with fp32 accumulation (see there).  K
//     and V tiles are double-buffered in shared memory with cp.async, so
//     the next tile is copied while this one is computed on.  It is the
//     simple tensor-core kernel: wgmma (the only way to the full rate),
//     TMA and warp specialisation are later work.
//   * fp32: flash_fwd, on the CUDA cores in fp32 (67 TFLOP/s peak), for
//     the fp32 configs the parity tests run; it takes fp32 only.
// What both do:
//   * One block per (batch * head, tile of 64 query rows).  The block
//     walks 64-key tiles of K and V through shared memory and keeps the
//     online softmax (running max m, running sum l, the 64 x D
//     accumulator) in registers, in fp32.  Scores and probabilities never
//     reach device memory.
//   * Tiles wholly outside the causal or window range are skipped (the
//     reference's pl.when), and query tiles are issued last-first so the
//     longest causal rows start first.
//   * A ragged S is masked here: keys and values past S are loaded as 0 and
//     masked out, rows past S are not written.
// In flash_fwd each thread owns a 4 x 4 block of the 64 x 64 score tile and
// a 4 x (D/16) block of the output, and reads shared memory as float4 in
// both products (rows padded by 4 floats, so a warp's reads hit distinct
// banks); the probability tile is written over the key tile once the
// scores are formed, so D = 128 needs 98 KB and two blocks fit an SM.
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
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, H, KV;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window;
  float scale;
};

template <int D>
constexpr int smem_bytes() {
  // Q tile and K tile (rows of D + 4 floats), V tile (rows of D floats).
  return (kBQ * (D + 4) + kBK * (D + 4) + kBK * D) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(Args a) {
  constexpr int QS = D + 4;    // row stride of the Q and K tiles (floats)
  constexpr int PS = kBK + 4;  // row stride of the probability tile
  constexpr int DJ = D / 64;   // float4 groups of output columns a thread owns
  static_assert(kBQ * PS <= kBK * QS, "the probability tile must fit the key tile");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Ks;  // the key tile's space, once the scores are formed

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16*j, output columns 4*tx + 64*j
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty + 3
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int g = h / (a.H / a.KV);
  const int S = a.S;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + g * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + g * a.vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * QS + d] = s < S ? qb[s * a.qss + d] : 0.f;
  }

  int kt_end = (S + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kBK : 0;

  float m[4], l[4], acc[4][4 * DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of Ks/Ps and Vs are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D, s = k0 + c;
      const bool in = s < S;
      Ks[c * QS + d] = in ? kb[s * a.kss + d] : 0.f;
      Vs[c * D + d] = in ? vb[s * a.vss + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[i][j];
          s = fmaf(qf[i].x, kf[j].x, s);
          s = fmaf(qf[i].y, kf[j].y, s);
          s = fmaf(qf[i].z, kf[j].z, s);
          s = fmaf(qf[i].w, kf[j].w, s);
          sc[i][j] = s;
        }
    }

    // Mask, then the online softmax update, one row at a time.  The 16
    // threads that share a row are one half-warp: shuffles of xor 1..8.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < S && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || kpos > qpos - a.window);
        sc[i][j] = ok ? sc[i][j] * a.scale : -INFINITY;
        mt = fmaxf(mt, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float alpha = 1.f;
      if (m_new == -INFINITY) {  // nothing in range yet: p = 0, state unchanged
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      } else {
        alpha = expf(m[i] - m_new);  // 0 while m[i] is -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = expf(sc[i][j] - m_new);  // masked: exp(-inf) = 0
      }
      float rs = sc[i][0] + sc[i][1] + sc[i][2] + sc[i][3];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * DJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread has read Ks: the probabilities go over it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * ty + i) * PS + tx + 16 * j] = sc[i][j];
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[i] = *reinterpret_cast<const float4*>(&Ps[(4 * ty + i) * PS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float4 vf = *reinterpret_cast<const float4*>(&Vs[(c + cc) * D + 64 * jj + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pf[i].x : cc == 1 ? pf[i].y : cc == 2 ? pf[i].z : pf[i].w;
            acc[i][4 * jj + 0] = fmaf(p, vf.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vf.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vf.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vf.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

  float* ob = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // rows with no key in range -> 0
    float* orow = ob + ((static_cast<int64_t>(b) * S + s) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[64 * jj + 4 * tx + e] = acc[i][4 * jj + e] / li;
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------
//
// Four warps a block, each owning 16 of the tile's 64 query rows.  Q, K and
// V tiles sit in shared memory in bf16 (rows padded by 8 elements, so the
// fragment loads of a warp hit 32 distinct banks).  Per 64-key tile a warp
// forms its 16 x 64 scores as 8 x (D/16) mma's from Q fragments kept in
// registers, masks and runs the online softmax on the accumulators (a row
// lives in the 4 threads of a quad), packs the probabilities to bf16 -- the
// score accumulators of two neighbouring 8-key tiles are exactly the A
// fragment of a 16-key step -- and multiplies them into its 16 x D output
// accumulators with V fragments read by ldmatrix.trans.  The running max,
// sum and the output stay fp32.

constexpr int kMmaThreads = 128;

template <int D>
constexpr int mma_smem_bytes() {
  return (kBQ + 4 * kBK) * (D + 8) * 2;  // Q, and two stages of K and V, bf16
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without a register; zeros when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start copying rows [s0, s0 + 64) of an (S, D) slab with row stride `ls`
// into a tile of row stride D + 8, 16 bytes a copy, zeros past S.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                                int64_t ls, int s0, int S) {
  constexpr int V = D / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < kBK * V; i += kMmaThreads) {
    const int r = i / V, d = (i % V) * 8, s = s0 + r;
    cp_async16(&tile[r * (D + 8) + d], s < S ? base + s * ls + d : base, s < S);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma(Args a) {
  constexpr int TS = D + 8;     // row stride of the tiles (elements)
  constexpr int NT = kBK / 8;   // 8-key score tiles a warp holds
  constexpr int KS = D / 16;    // 16-wide steps of the score product
  constexpr int OT = D / 8;     // 8-wide output tiles a warp holds

  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Kbuf = Qs + kBQ * TS;      // two stages of K
  __nv_bfloat16* Vbuf = Kbuf + 2 * kBK * TS;  // two stages of V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int S = a.S;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.vsb + kvh * a.vsh;

  int kt_end = (S + kBK - 1) / kBK;
  if (a.causal) kt_end = min(kt_end, q_last / kBK + 1);
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kBK : 0;

  // Q and the first K/V tile in one group; each later tile is copied while
  // the one before it is computed on.
  load_tile_async<D>(Qs, qb, a.qss, q0, S);
  load_tile_async<D>(Kbuf, kb, a.kss, kt_begin * kBK, S);
  load_tile_async<D>(Vbuf, vb, a.vss, kt_begin * kBK, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = ld32(&Qs[r0 * TS + c]);
    qf[ks][1] = ld32(&Qs[(r0 + 8) * TS + c]);
    qf[ks][2] = ld32(&Qs[r0 * TS + c + 8]);
    qf[ks][3] = ld32(&Qs[(r0 + 8) * TS + c + 8]);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = kt_begin, stage = 0; kt < kt_end; ++kt, stage ^= 1) {
    const int k0 = kt * kBK;
    const __nv_bfloat16* Ks = Kbuf + stage * kBK * TS;
    const __nv_bfloat16* Vs = Vbuf + stage * kBK * TS;
    if (kt + 1 < kt_end) {  // the other stage was freed by the last iteration's barrier
      load_tile_async<D>(Kbuf + (stage ^ 1) * kBK * TS, kb, a.kss, k0 + kBK, S);
      load_tile_async<D>(Vbuf + (stage ^ 1) * kBK * TS, vb, a.vss, k0 + kBK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group is in; the next one may be in flight
    __syncthreads();

    // Scores: B fragments of two 16-wide steps from one ldmatrix.x4 (lanes
    // 8i..8i+7 address the key rows of 8-column group i).
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(n * 8 + (lane & 7)) * TS + (lane >> 3) * 8];
#pragma unroll
      for (int ks = 0; ks < KS; ks += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, krow + ks * 16);
        mma_bf16(sc[n], qf[ks], bf);
        mma_bf16(sc[n], qf[ks + 1], bf + 2);
      }
    }

    // Mask and the online softmax, for rows r0 (accumulators 0, 1) and
    // r0 + 8 (2, 3); a row's 64 scores are spread over a quad.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = q0 + r0 + 8 * half;
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + n * 8 + 2 * t + e;
          const bool ok = kpos < S && (!a.causal || kpos <= qpos) &&
                          (a.window <= 0 || kpos > qpos - a.window);
          float& v = sc[n][2 * half + e];
          v = ok ? v * a.scale : -INFINITY;
          mt = fmaxf(mt, v);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[half], mt);
      const bool none = m_new == -INFINITY;  // nothing in range yet
      const float alpha = none ? 1.f : expf(m[half] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sc[n][2 * half + e];
          v = none ? 0.f : expf(v - m_new);
          rs += v;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[half] = l[half] * alpha + rs;
      m[half] = m_new;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        o[j][2 * half] *= alpha;
        o[j][2 * half + 1] *= alpha;
      }
    }

    // o += P V: the probabilities of key tiles 2kk and 2kk + 1 are the A
    // fragment of the kk-th 16-key step.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      // B fragments of two 8-wide output tiles from one ldmatrix.x4.trans:
      // lanes 0-15 address keys kk*16 + 0..15 at column 8j, lanes 16-31 the
      // same keys at column 8j + 8.
      const __nv_bfloat16* vrow = &Vs[(kk * 16 + (lane & 15)) * TS + (lane >> 4) * 8];
#pragma unroll
      for (int j = 0; j < OT; j += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vrow + j * 8);
        mma_bf16(o[j], pa, bf);
        mma_bf16(o[j + 1], pa, bf + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = q0 + r0 + 8 * half;
    if (s >= S) continue;
    const float li = l[half] == 0.f ? 1.f : l[half];  // rows with no key in range -> 0
    __nv_bfloat16* orow = ob + ((static_cast<int64_t>(b) * S + s) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(o[j][2 * half] / li, o[j][2 * half + 1] / li);
  }
}

template <int D>
cudaError_t launch(const Args& a, bool bf16, cudaStream_t stream) {
  const dim3 grid(a.B * a.H, (a.S + kBQ - 1) / kBQ);
  if (bf16) {
    constexpr int smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_mma<D><<<grid, kMmaThreads, smem, stream>>>(a);
  } else {
    constexpr int smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd<D><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D,
                                      int64_t qsb, int64_t qss, int64_t qsh,
                                      int64_t ksb, int64_t kss, int64_t ksh,
                                      int64_t vsb, int64_t vss, int64_t vsh,
                                      int causal, int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      static_cast<int64_t>(B) * H > 0x7fffffff || (S + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, B, S, H, KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == 1;
  return static_cast<int>(D == 64 ? launch<64>(a, bf16, st) : launch<128>(a, bf16, st));
}
