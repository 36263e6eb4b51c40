// flash_attention: causal or full GQA attention, the forward, with an
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
// the products belong on the tensor cores, and only wgmma reaches their
// full rate.  Two paths, one per dtype:
//   * bf16 (the models' dtype, the main path): flash_fwd_wgmma, one block
//     of three warpgroups per (batch * head, 128 query rows).  Warpgroup 0
//     is the producer: it gives up registers (setmaxnreg) and one thread
//     issues TMA loads -- the Q tile once, then 128-key tiles of K and V
//     into a ring of two stages of 128-byte-swizzled shared memory, each
//     stage guarded by full / empty mbarriers.  Warpgroups 1 and 2 are the
//     consumers, 64 query rows each: S = Q K^T is wgmma m64n128k16 with
//     both operands in shared memory, the online softmax runs in fp32 on
//     the accumulator fragment, P is packed to bf16 in registers -- the
//     accumulator layout of m64nN is the register A fragment of the next
//     k16 step -- and O += P V is wgmma m64nDk16 with V read through the
//     transpose bit.  O stays in registers; the epilogue divides by l and
//     stores rows < S.  The tensor maps are built on the host with
//     cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, so the
//     library needs no -lcuda.  q and o map as (D, H, S, B), k and v as
//     (D, KV, S, B): GQA is an index.  A D = 128 row is two 64-column
//     boxes (the 128-byte swizzle's width).
//   * fp32: flash_fwd, on the CUDA cores in fp32 (67 TFLOP/s peak), for
//     the fp32 configs the parity tests run; it takes fp32 only.
// What both do:
//   * Each block walks key tiles through shared memory and keeps the
//     online softmax (running max m, running sum l, the accumulator) in
//     registers, in fp32.  Scores and probabilities never reach device
//     memory.
//   * Tiles wholly outside the causal or window range are skipped (the
//     reference's pl.when); only tiles that cross the diagonal, the
//     window's edge or the ragged end of S are masked.  Query tiles are
//     issued last-first so the longest causal rows start first.
//   * A ragged S needs no padded copy: keys and values past S are zeros
//     (TMA fills them; flash_fwd loads them as 0) and masked out, rows past
//     S are not written.
// What holds the bf16 kernel back now (no profiler counters on the card,
// so inferred): the two consumers take turns with nothing in between --
// a consumer's softmax does not overlap its own or the other's products
// (FA3's ping-pong and intra-warpgroup overlap are later work), each
// product waits for its wgmma group to finish, and blocks are not
// persistent, so a block's epilogue does not overlap the next one's loads.
//
// In flash_fwd each thread owns a 4 x 4 block of the 64 x 64 score tile and
// a 4 x (D/16) block of the output, and reads shared memory as float4 in
// both products (rows padded by 4 floats, so a warp's reads hit distinct
// banks); the probability tile is written over the key tile once the
// scores are formed, so D = 128 needs 98 KB and two blocks fit an SM.
//
// With a non-null `lse` both paths also write the row log-sum-exp of the
// scaled scores, fp32 (B, H, S), natural log (+inf for a row with no key in
// range), which flash_attention_bwd.cu reads; the prefill passes null.
//
// Interface: plain C, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for arguments it does
// not take (for bf16 also a base address or a stride that is not a multiple
// of 16 bytes, which TMA cannot address).  Launches on the given stream and
// does not synchronize.

#include <cuda.h>
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
  float* lse;  // (B, H, S) row log-sum-exp for the backward, or null
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
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<int64_t>(b) * a.H + h) * S + s] = l[i] == 0.f ? INFINITY : m[i] + logf(l[i]);
    const float li = l[i] == 0.f ? 1.f : l[i];  // rows with no key in range -> 0
    float* orow = ob + ((static_cast<int64_t>(b) * S + s) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[64 * jj + 4 * tx + e] = acc[i][4 * jj + e] / li;
  }
}



// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 384;  // three warpgroups
constexpr int kWsBQ = 128;       // query rows per block, 64 per consumer
constexpr int kWsBK = 128;       // keys per tile
constexpr int kStages = 2;       // K / V ring depth
constexpr int kBox = 64;         // bf16 columns of one 128-byte swizzled box
constexpr int kBoxBytes = 128 * kBox * 2;  // a 128-row box: 16 KB

struct WsArgs {
  void* o;
  float* lse;
  int S, H, KV;
  int causal, window;
  float scale_log2;  // 1/sqrt(D) * log2(e): the softmax runs in base 2
};

template <int D>
constexpr int ws_smem_bytes() {
  return 1024 + (1 + 2 * kStages) * 128 * D * 2;  // alignment slack, Q, K and V stages
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// Until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// One box of a 4-d tensor map into shared memory; completion (the box's
// bytes, zeros for coordinates out of range included) goes to `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma operand descriptor for a tile in 128-byte-swizzled shared memory
// (rows of 128 bytes, 8-row groups 1024 bytes apart, 1024-aligned groups):
// `lbo` is the byte distance between 64-column boxes, which only an
// operand read through the transpose bit (V, 128 columns) uses.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from reading (or reusing) registers that an
// asynchronous wgmma still writes or reads before the wait that ends it.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D (64 x N fp32, the accumulator fragment) (+)= A (64 x 16) . B (16 x N):
// ss takes A and B from shared memory (both K-major), rs takes A from
// registers (the m16n8k16 A-fragment layout, a warp's 16 rows each) and B
// through the transpose bit (N contiguous in shared memory).
__device__ __forceinline__ void wgmma_ss_m64n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, WsArgs a) {
  constexpr int kBoxes = D / kBox;          // 64-column boxes a row
  constexpr int kTile = 128 * D * 2;        // bytes of a Q, K or V tile
  constexpr int kNT = kWsBK / 8;            // 8-key column groups of the score fragment
  constexpr int kOT = D / 8;                // 8-wide column groups of the output fragment

  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  uint64_t* q_full = &bars[0];
  uint64_t* k_full = &bars[1];
  uint64_t* v_full = &bars[1 + kStages];
  uint64_t* empty = &bars[1 + 2 * kStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  uint8_t* Ks = Qs + kTile;
  uint8_t* Vs = Ks + kStages * kTile;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int g = h / (a.H / a.KV);
  const int S = a.S;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWsBQ;
  const int q_last = min(q0 + kWsBQ, S) - 1;
  int kt_end = (S + kWsBK - 1) / kWsBK;
  if (a.causal) kt_end = min(kt_end, q_last / kWsBK + 1);
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kWsBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTile);
      for (int x = 0; x < kBoxes; ++x) tma_load_4d(Qs + x * kBoxBytes, &tq, q_full, x * kBox, h, q0, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);  // passes at once on the first round
        mbar_expect_tx(&k_full[st], kTile);
        for (int x = 0; x < kBoxes; ++x)
          tma_load_4d(Ks + st * kTile + x * kBoxBytes, &tk, &k_full[st], x * kBox, g, kt * kWsBK, b);
        mbar_expect_tx(&v_full[st], kTile);
        for (int x = 0; x < kBoxes; ++x)
          tma_load_4d(Vs + st * kTile + x * kBoxBytes, &tv, &v_full[st], x * kBox, g, kt * kWsBK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each --------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int t = lane & 3;                             // thread in its quad
    const int row_lo = q0 + 64 * c;                     // this warpgroup's rows
    const int row_hi = row_lo + 63;
    const int r0 = row_lo + 16 * warp + (lane >> 2);    // this thread's rows: r0 and r0 + 8
    const uint32_t q_addr = smem_addr(Qs) + c * 64 * 128;
    const uint32_t k_addr = smem_addr(Ks);
    const uint32_t v_addr = smem_addr(Vs);

    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int st = i % kStages;
      const int parity = (i / kStages) & 1;
      const int k0 = kt * kWsBK;

      // S = Q K^T: D/16 steps of k16; a step is 32 bytes into a box.
      float s[kWsBK / 2];
      mbar_wait(&k_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
        wgmma_ss_m64n128(s, sw128_desc(q_addr + off, 16),
                         sw128_desc(k_addr + st * kTile + off, 16), ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<kWsBK / 2>(s);

      // Mask (only tiles that cross the diagonal, the window's edge or S),
      // then the online softmax in base 2.  s[4j + 2*half + e] is row
      // r0 + 8*half, key k0 + 8j + 2t + e; a row lives in the 4 threads of
      // a quad.
      const bool need_mask = k0 + kWsBK > S || (a.causal && k0 + kWsBK - 1 > row_lo) ||
                             (a.window > 0 && k0 <= row_hi - a.window);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + 2 * t + e;
              const int qpos = r0 + 8 * half;
              const bool ok = kpos < S && (!a.causal || kpos <= qpos) &&
                              (a.window <= 0 || kpos > qpos - a.window);
              if (!ok) s[4 * j + 2 * half + e] = -INFINITY;
            }
      }
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mt = fmaxf(mt, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[half], mt * a.scale_log2);
        // Nothing in range yet: every score is -inf, p = 0 and alpha = 1.
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[half] = exp2f(m[half] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = s[4 * j + 2 * half + e];
            v = exp2f(fmaf(v, a.scale_log2, -m_use));  // masked: exp2(-inf) = 0
            rs += v;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[half] = l[half] * alpha[half] + rs;
        m[half] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kOT; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // P in bf16: the score columns of key groups 2kk and 2kk + 1 are the
      // A fragment of the kk-th 16-key step.
      uint32_t p[kWsBK / 4];
#pragma unroll
      for (int kk = 0; kk < kWsBK / 16; ++kk) {
        p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V: V's 16 key rows of step kk are 2048 bytes on; its second
      // 64-column box (D = 128) is one box further (the descriptor's LBO).
      mbar_wait(&v_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWsBK / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_addr + st * kTile + kk * 16 * 128, kBoxBytes);
        if constexpr (D == 128) {
          wgmma_rs_m64n128(o, &p[4 * kk], dv);
        } else {
          wgmma_rs_m64n64(o, &p[4 * kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<D / 2>(o);
      pin<kWsBK / 4>(p);
      mbar_arrive(&empty[st]);
    }

    // Epilogue: o / l in bf16, rows past S not stored; l == 0 gives 0.
    // The row log-sum-exp, if asked for, in natural log: m and l are kept
    // in base 2 with the scale folded in.
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= S) continue;
      if (a.lse != nullptr && t == 0)
        a.lse[(static_cast<int64_t>(b) * a.H + h) * S + row] =
            l[half] == 0.f ? INFINITY : (m[half] + log2f(l[half])) * 0.6931471805599453f;
      const float inv = l[half] == 0.f ? 0.f : 1.f / l[half];
      __nv_bfloat16* orow = ob + ((static_cast<int64_t>(b) * S + row) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < kOT; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A (B, S, heads, D) bf16 tensor with element strides (sb, ss, sh, 1) as a
// 4-d map (D, heads, S, B) read in boxes of 64 columns x 1 head x 128 rows,
// 128-byte swizzled.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, int64_t sb, int64_t ss, int64_t sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, 1, kWsBQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA addresses a base on 16 bytes and strides that are multiples of 16
// bytes, below 2^40; the wrapper copies a tensor otherwise.
bool tma_ok(const void* p, int64_t s0, int64_t s1, int64_t s2) {
  const int64_t lim = int64_t(1) << 39;  // elements of 2 bytes
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 > 0 && s1 > 0 && s2 > 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0 && s0 < lim && s1 < lim && s2 < lim;
}

template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  if (!tma_ok(a.q, a.qsb, a.qss, a.qsh) || !tma_ok(a.k, a.ksb, a.kss, a.ksh) ||
      !tma_ok(a.v, a.vsb, a.vss, a.vsh) || reinterpret_cast<uintptr_t>(a.o) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, a.q, a.B, a.S, a.H, D, a.qsb, a.qss, a.qsh) ||
      !make_map(enc, &tk, a.k, a.B, a.S, a.KV, D, a.ksb, a.kss, a.ksh) ||
      !make_map(enc, &tv, a.v, a.B, a.S, a.KV, D, a.vsb, a.vss, a.vsh)) {
    return cudaErrorInvalidValue;
  }
  const WsArgs w{a.o, a.lse, a.S, a.H, a.KV, a.causal, a.window, a.scale * 1.4426950408889634f};
  constexpr int smem = ws_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kWsBQ - 1) / kWsBQ);
  flash_fwd_wgmma<D><<<grid, kWsThreads, smem, stream>>>(tq, tk, tv, w);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, bool bf16, cudaStream_t stream) {
  if (bf16) return launch_bf16<D>(a, stream);
  const dim3 grid(a.B * a.H, (a.S + kBQ - 1) / kBQ);
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int B, int S, int H, int KV, int D,
                                      int64_t qsb, int64_t qss, int64_t qsh,
                                      int64_t ksb, int64_t kss, int64_t ksh,
                                      int64_t vsb, int64_t vss, int64_t vsh,
                                      int causal, int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      static_cast<int64_t>(B) * H > 0x7fffffff || (S + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, lse, B, S, H, KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == 1;
  return static_cast<int>(D == 64 ? launch<64>(a, bf16, st) : launch<128>(a, bf16, st));
}
