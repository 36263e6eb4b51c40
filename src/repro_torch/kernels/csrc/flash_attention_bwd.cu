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
// the scaled scores, fp32 (B, H, Sq), from flash_attention.cu) and dO:
//
//     P  = exp(q k^T * scale - lse)          (recomputed, never stored)
//     dV = sum over the G query heads of P^T dO
//     dP = dO v^T,  Delta = rowsum(dO * o),  dS = P * (dP - Delta)
//     dQ = dS k * scale,  dK = sum over the G query heads of dS^T q * scale
//
// over the keys in range for each query (j <= i when causal, j > i - window
// with a window, i < Sq, j < Sk; both count from 0).  dq is (B, Sq, H, D),
// dk and dv (B, Sk, KV, D), all contiguous and in q's dtype.  Sk may be
// longer or shorter than Sq (whisper's cross-attention, 448 queries over
// 1500 keys): the dQ kernel's grid and query tiles run over Sq, its key
// tiles over Sk; the dK / dV kernel's grid and key tiles over Sk, its query
// tiles over Sq.
//
// What bounds it: operations.  At olmo-1b's shape (B = 4, S = 2048, H = KV =
// 16, D = 128, bf16, causal) the five products it needs (S, dP, dV, dK, dQ)
// are 2.5 times the forward's 68.7 GFLOP = 171.8 GFLOP: 0.1737 ms at the
// H100's 989 TFLOP/s of bf16 tensor-core work, against about 0.27 GB of
// inputs and outputs (0.08 ms).  Two kernels, in order, on the stream, each
// output with one writer and no atomics (the result is the same run to
// run):
//   * dQ: one block per (b, query head, 128 query rows), walking the key
//     tiles in range as the forward does.  It recomputes S and dP -- seven
//     products where five are needed (the recompute is not counted in the
//     bound) -- and forms its rows' Delta = rowsum(dO * o) and lse in base 2
//     itself, storing both for the second kernel.
//   * dK and dV: one block per (b, KV head, 128 keys); it keeps its keys'
//     dK and dV in registers and walks the G query heads and every query
//     tile the mask lets reach its keys, recomputing S^T and dP^T for each.
// Tiles wholly outside the causal or window range are skipped (per block,
// and per consumer warpgroup); only tiles that cross the diagonal, the
// window's edge or the ragged end of Sq or Sk are masked.
//
// bf16 (the models' dtype, the main path): both kernels are warp-
// specialised wgmma kernels built from the forward's machinery
// (flash_attention.cu).  A block is three warpgroups.  Warpgroup 0 is the
// producer: it gives up registers (setmaxnreg) and one thread issues TMA
// loads into 128-byte-swizzled shared memory, each ring stage guarded by
// full / empty mbarriers.  Warpgroups 1 and 2 are the consumers, 64 rows
// each, with 240 registers.
//   * bwd_dq_wgmma: Q and dO are held; 128-key tiles of K and V stream
//     through a ring of kQStages.  S = Q K^T and dP = dO V^T are wgmma
//     m64n128k16 with both operands in shared memory, issued as two commit
//     groups so P is formed while dP is still running; dS = P (dP - Delta)
//     in fp32 on the accumulator, packed to bf16 in registers -- the
//     accumulator layout of m64nN is the register A fragment of the next
//     k16 step -- and dQ += dS K with K read through the transpose bit, as
//     the forward reads V.
//   * bwd_dkdv_wgmma: K and V are loaded once and held; the producer
//     streams 64-row query tiles of Q and dO, with their rows of lse and
//     Delta, through a ring of kKvStages.  S^T = K Q^T and dP^T = V dO^T
//     are wgmma m64n64k16 from shared memory; P^T and dS^T are formed on
//     the accumulator and packed to bf16 as above; dV += P^T dO is issued
//     before dS^T is formed, so that product overlaps the elementwise
//     work, then dK += dS^T Q (Q and dO through the transpose bit).
//   The tensor maps are built on the host with cuTensorMapEncodeTiled,
//   found through cudaGetDriverEntryPoint (no -lcuda).  q and dO map as
//   (D, H, Sq, B), k and v as (D, KV, Sk, B): GQA is an index; a D = 128 row
//   is two 64-column boxes (the swizzle's width).  lse and Delta map as
//   rows of a (2 * B * H, round_up(Sq, 4)) fp32 scratch.  TMA fills rows
//   past Sq (q, dO, lse, Delta) or Sk (k, v) with zeros; those rows and
//   columns are masked: a query past Sq has zero q and dO and a zero lse,
//   so its P would be exp2(0) -- the dK / dV kernel's mask (qpos < Sq) sets
//   it to 0 before it reaches dK or dV.  A row with no
//   key in range has lse = +inf, so P = 0.  The loop-invariant operand
//   addresses are laundered each trip (`fresh`), or the compiler hoists
//   their descriptors and spills.
// fp32: bwd_delta (Delta, one warp a row), then the same two passes on the
// CUDA cores in fp32, 32-row tiles, 256 threads; for the fp32 configs the
// parity runs use.
// What holds the bf16 kernels back now (no profiler counters on the card,
// so inferred from edited copies timed on it): the dQ kernel's recompute
// of S and dP (two of its three products); the consumers' elementwise
// work, which the products do not fully hide (a ping-pong of the two
// consumers on named barriers, deferring a trip's last wait into the next
// trip, deeper rings and even skipping the tile loads gained nothing);
// blocks are not persistent, so each block's K / V (or Q / dO) load and
// its epilogue are not overlapped with another block's products.
//
// Interface: plain C, loaded with ctypes.  Returns cudaGetLastError() after
// the launches (0 = launched), or cudaErrorInvalidValue for arguments it does
// not take (for bf16 also a base or a stride of q, k, v, o or dO that is
// not a multiple of 16 bytes: TMA and the 16-byte loads of o and dO cannot
// address it).  Launches on the given stream and does not synchronize.
// `delta` is the caller's fp32 scratch of 2 * B * H * round_up(Sq, 4) floats.

#include <cuda.h>
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
  float* delta;  // fp32: Delta (B, H, Sq); bf16: Delta, then lse * log2(e), rows of
                 // round_up(Sq, 4) floats
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KV;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, dsb, dss, dsh;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool allowed(int qpos, int kpos, const BwdArgs& a) {
  return qpos < a.Sq && kpos < a.Sk && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// The first and one-past-last query tiles (of `tile` rows) whose queries can
// reach keys [k0, k0 + tile).
__device__ __forceinline__ void query_tiles(const BwdArgs& a, int k0, int tile, int* first,
                                            int* end) {
  const int n = (a.Sq + tile - 1) / tile;
  *first = a.causal ? k0 / tile : 0;
  *end = n;
  if (a.window > 0) *end = min(n, (k0 + tile - 1 + a.window - 1) / tile + 1);
}

// The first and one-past-last key tiles that queries [q0, q0 + tile) reach.
__device__ __forceinline__ void key_tiles(const BwdArgs& a, int q0, int tile, int* first,
                                          int* end) {
  const int q_last = min(q0 + tile, a.Sq) - 1;
  *end = (a.Sk + tile - 1) / tile;
  if (a.causal) *end = min(*end, q_last / tile + 1);
  *first = a.window > 0 ? max(0, q0 - a.window + 1) / tile : 0;
}

// ---------------------------------------------------------------------------
// fp32: Delta = rowsum(dO * o), (B, H, Sq): one warp a row.  (The bf16 dQ
// kernel forms its rows' Delta itself.)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256) bwd_delta(BwdArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(a.B) * a.Sq * a.H) return;
  const int h = static_cast<int>(row % a.H);
  const int64_t bs = row / a.H;
  const int s = static_cast<int>(bs % a.Sq);
  const int b = static_cast<int>(bs / a.Sq);
  const float* orow = static_cast<const float*>(a.o) + b * a.osb + s * a.oss + h * a.osh;
  const float* drow = static_cast<const float*>(a.dout) + b * a.dsb + s * a.dss + h * a.dsh;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[(static_cast<int64_t>(b) * a.H + h) * a.Sq + s] = acc;
}

// 2^x in one MUFU instruction (ex2.approx; results below 2^-126 flush to
// 0, and -inf gives 0).  exp2f without fast-math takes several more
// instructions, and the exponentials sit on the consumers' critical path.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 384;  // three warpgroups
constexpr int kBN = 128;         // a dK/dV block's keys; a dQ block's query rows and key tiles
constexpr int kBM = 64;          // query rows of a tile the dK/dV kernel streams
constexpr int kKvStages = 2;     // ring depth of the dK/dV kernel (Q, dO, lse, Delta)
constexpr int kQStages = 2;      // ring depth of the dQ kernel (K, V)
constexpr int kBox = 64;         // bf16 columns of one 128-byte swizzled box

struct WsArgs {
  const void* o;
  const void* dout;
  const float* lse;    // (B, H, Sq), natural log
  float* scratch;      // (B, H, ldl) Delta, then (B, H, ldl) lse in base 2
  void* dq;
  void* dk;
  void* dv;
  int64_t osb, oss, osh, dsb, dss, dsh;
  int B, Sq, Sk, H, KV, ldl;
  int causal, window;
  float scale;
  float scale_log2;    // scale * log2(e): the exponentials run in base 2
};

template <int D>
constexpr int dkdv_smem_bytes() {  // alignment slack, K and V, stages of Q, dO, lse and Delta
  return 1024 + 2 * kBN * D * 2 + kKvStages * (2 * kBM * D * 2 + 2 * kBM * 4);
}

template <int D>
constexpr int dq_smem_bytes() {  // alignment slack, Q and dO, stages of K and V
  return 1024 + 2 * kBN * D * 2 + kQStages * 2 * kBN * D * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// One box of a 4-d (2-d) tensor map into shared memory; completion (the
// box's bytes, zeros for coordinates out of range included) goes to `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma operand descriptor for a tile in 128-byte-swizzled shared memory
// (rows of 128 bytes, 8-row groups 1024 bytes apart, 1024-aligned groups):
// `lbo` is the byte distance between 64-column boxes, which only an
// operand read through the transpose bit (128 columns) uses.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// A shared-memory address the compiler must treat as new on every loop
// trip: the descriptors built from it are then formed next to their wgmma
// (a few integer adds) instead of hoisted out of the loop, where the 32
// registers they would hold push the accumulators into spills.
__device__ __forceinline__ uint32_t fresh(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return addr;
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
__device__ __forceinline__ void wgmma_ss_m64n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The rs product with N = D (the head width).
template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_m64n128(d, a, db);
  } else {
    wgmma_rs_m64n64(d, a, db);
  }
}

// Two neighbouring 8-column groups of an accumulator (16 columns) as the
// bf16 A fragment of one k16 step: acc[4j + 2 * half + e] is row
// (lane / 4) + 8 * half of the warp's 16, column 8j + 2 * (lane % 4) + e.
template <int N>
__device__ __forceinline__ void to_a(uint32_t* a, const float* acc) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[4 * kk + 0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
    a[4 * kk + 1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[4 * kk + 2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[4 * kk + 3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// The accumulator fragment (rows r0 and r0 + 8, D columns) times `mul`, in
// bf16, into row-major rows of `ld` elements; rows >= S (the rows' length,
// Sq or Sk) are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t ld, const float* acc,
                                           int r0, int S, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= S) continue;
    __nv_bfloat16* p = base + static_cast<int64_t>(row) * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

// dK and dV of 128 keys of one KV head: consumer c owns keys
// k0 + 64c .. + 63 and walks every (query head, 64-row query tile) the mask
// lets reach the block's keys.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tld, WsArgs a) {
  constexpr int kBoxes = D / kBox;   // 64-column boxes a row
  constexpr int kKTile = kBN * D * 2;  // bytes of the K or V tile
  constexpr int kKBox = kBN * 128;     // bytes of one of its boxes
  constexpr int kQTile = kBM * D * 2;  // bytes of a Q or dO tile
  constexpr int kQBox = kBM * 128;
  constexpr int kNT = kBM / 8;         // 8-query column groups of the S^T fragment

  __shared__ __align__(8) uint64_t bars[1 + 2 * kKvStages];
  uint64_t* kv_full = &bars[0];
  uint64_t* full = &bars[1];
  uint64_t* empty = &bars[1 + kKvStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  uint8_t* Vs = Ks + kKTile;
  uint8_t* Qs = Vs + kKTile;
  uint8_t* Os = Qs + kKvStages * kQTile;                      // dO
  float* Ls = reinterpret_cast<float*>(Os + kKvStages * kQTile);  // a stage: lse (base 2), Delta

  const int b = blockIdx.x / a.KV;
  const int g = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const int Sq = a.Sq, Sk = a.Sk;
  const int k0 = blockIdx.y * kBN;
  // The 64-row query tiles whose queries reach keys [k0, k0 + kBN).
  const int qt_first = a.causal ? k0 / kBM : 0;
  int qt_end = (Sq + kBM - 1) / kBM;
  if (a.window > 0) qt_end = min(qt_end, (k0 + kBN - 2 + a.window) / kBM + 1);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&full[s], 1);
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
      mbar_expect_tx(kv_full, 2 * kKTile);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load_4d(Ks + x * kKBox, &tk, kv_full, x * kBox, g, k0, b);
        tma_load_4d(Vs + x * kKBox, &tv, kv_full, x * kBox, g, k0, b);
      }
      int i = 0;
      for (int h = g * G; h < (g + 1) * G; ++h) {
        for (int qt = qt_first; qt < qt_end; ++qt, ++i) {
          const int st = i % kKvStages;
          mbar_wait(&empty[st], ((i / kKvStages) & 1) ^ 1);  // passes at once on the first round
          mbar_expect_tx(&full[st], 2 * kQTile + 2 * kBM * 4);
          for (int x = 0; x < kBoxes; ++x) {
            tma_load_4d(Qs + st * kQTile + x * kQBox, &tq, &full[st], x * kBox, h, qt * kBM, b);
            tma_load_4d(Os + st * kQTile + x * kQBox, &tdo, &full[st], x * kBox, h, qt * kBM, b);
          }
          const int row = b * a.H + h;  // of the (2 B H, Sq) lse / Delta map
          tma_load_2d(Ls + st * 2 * kBM, &tld, &full[st], qt * kBM, a.B * a.H + row);
          tma_load_2d(Ls + st * 2 * kBM + kBM, &tld, &full[st], qt * kBM, row);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each --------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int t = lane & 3;                            // thread in its quad
    const int key_lo = k0 + 64 * c;                    // this warpgroup's keys
    const int r0 = key_lo + 16 * warp + (lane >> 2);   // this thread's keys: r0 and r0 + 8
    const uint32_t k_base = smem_addr(Ks) + c * 64 * 128;
    const uint32_t v_base = smem_addr(Vs) + c * 64 * 128;
    // The queries each of this thread's keys may see: [q_min, q_max], none
    // past Sq (their rows are TMA's zeros).
    int q_min[2], q_max[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = r0 + 8 * half;
      q_min[half] = a.causal ? key : 0;
      q_max[half] =
          key >= Sk ? -1 : a.window > 0 ? min(Sq - 1, key + min(a.window, Sq) - 1) : Sq - 1;
    }

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;

    mbar_wait(kv_full, 0);
    int i = 0;
    for (int h = g * G; h < (g + 1) * G; ++h) {
      for (int qt = qt_first; qt < qt_end; ++qt, ++i) {
        const int st = i % kKvStages;
        const int q0 = qt * kBM;
        mbar_wait(&full[st], (i / kKvStages) & 1);
        if (key_lo >= Sk || (a.causal && q0 + kBM - 1 < key_lo) ||
            (a.window > 0 && q0 - a.window >= key_lo + 63)) {
          mbar_arrive(&empty[st]);  // no pair of these keys and queries is in range
          continue;
        }
        const uint32_t q_addr = fresh(smem_addr(Qs) + st * kQTile);
        const uint32_t o_addr = fresh(smem_addr(Os) + st * kQTile);
        const uint32_t k_addr = fresh(k_base), v_addr = fresh(v_base);

        // S^T = K Q^T, then dP^T = V dO^T, as two groups: D/16 steps of k16,
        // a step 32 bytes into a box.
        float s[kBM / 2], dp[kBM / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_m64n64(s, sw128_desc(k_addr + (ks / 4) * kKBox + (ks % 4) * 32, 16),
                          sw128_desc(q_addr + (ks / 4) * kQBox + (ks % 4) * 32, 16), ks > 0);
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_m64n64(dp, sw128_desc(v_addr + (ks / 4) * kKBox + (ks % 4) * 32, 16),
                          sw128_desc(o_addr + (ks / 4) * kQBox + (ks % 4) * 32, 16), ks > 0);
        wgmma_commit();

        // P^T = exp2(S^T * scale_log2 - lse2[query]), masked where the tile
        // crosses the diagonal, the window's edge, Sq or Sk.  s[4j + 2*half + e]
        // is key r0 + 8*half, query q0 + 8j + 2t + e.
        const float* ls = Ls + st * 2 * kBM;
        const bool need_mask = q0 + kBM > Sq || key_lo + 64 > Sk ||
                               (a.causal && key_lo + 63 > q0) ||
                               (a.window > 0 && key_lo <= q0 + kBM - 1 - a.window);
        wgmma_wait<1>();
        pin<kBM / 2>(s);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * half + e];
              x = ex2(fmaf(x, a.scale_log2, -(e ? l2.y : l2.x)));
              const int qpos = q0 + 8 * j + 2 * t + e;
              if (need_mask && (qpos < q_min[half] || qpos > q_max[half])) x = 0.f;
            }
        }
        uint32_t pa[kBM / 4];
        to_a<kBM>(pa, s);

        // dV += P^T dO: dO's 16 query rows of step kk are 2048 bytes on; its
        // second 64-column box (D = 128) is one box further (the LBO).
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs_nd<D>(dv, &pa[4 * kk], sw128_desc(o_addr + kk * 16 * 128, kQBox));
        wgmma_commit();

        // dS^T = P^T (dP^T - Delta[query]), while dV runs.
        wgmma_wait<1>();
        pin<kBM / 2>(dp);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(ls + kBM + 8 * j + 2 * t);
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * j + 2 * half + e;
              dp[idx] = s[idx] * (dp[idx] - (e ? dl.y : dl.x));
            }
        }
        uint32_t da[kBM / 4];
        to_a<kBM>(da, dp);

        // dK += dS^T Q.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs_nd<D>(dk, &da[4 * kk], sw128_desc(q_addr + kk * 16 * 128, kQBox));
        wgmma_commit();
        wgmma_wait<0>();
        pin<D / 2>(dv);
        pin<D / 2>(dk);
        pin<kBM / 4>(pa);
        pin<kBM / 4>(da);
        mbar_arrive(&empty[st]);
      }
    }

    // Epilogue: dK * scale and dV in bf16, keys past Sk not stored.
    const int64_t ld = static_cast<int64_t>(a.KV) * D;
    const int64_t off = (static_cast<int64_t>(b) * Sk * a.KV + g) * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(a.dk) + off, ld, dk, r0, Sk, a.scale);
    store_rows<D>(static_cast<__nv_bfloat16*>(a.dv) + off, ld, dv, r0, Sk, 1.f);
  }
}

// dQ of 128 query rows of one query head: consumer c owns rows
// q0 + 64c .. + 63 and walks the 128-key tiles in range.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 WsArgs a) {
  constexpr int kBoxes = D / kBox;
  constexpr int kTile = kBN * D * 2;   // bytes of a Q, dO, K or V tile
  constexpr int kBoxBytes = kBN * 128;
  constexpr int kNT = kBN / 8;         // 8-key column groups of the score fragment

  __shared__ __align__(8) uint64_t bars[1 + 2 * kQStages];
  uint64_t* q_full = &bars[0];
  uint64_t* full = &bars[1];
  uint64_t* empty = &bars[1 + kQStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Os = Qs + kTile;                 // dO
  uint8_t* Ks = Os + kTile;
  uint8_t* Vs = Ks + kQStages * kTile;

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int g = h / (a.H / a.KV);
  const int Sq = a.Sq, Sk = a.Sk;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBN;  // the longest causal rows first
  const int q_last = min(q0 + kBN, Sq) - 1;
  int kt_end = (Sk + kBN - 1) / kBN;
  if (a.causal) kt_end = min(kt_end, q_last / kBN + 1);
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kBN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * kTile);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load_4d(Qs + x * kBoxBytes, &tq, q_full, x * kBox, h, q0, b);
        tma_load_4d(Os + x * kBoxBytes, &tdo, q_full, x * kBox, h, q0, b);
      }
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int st = i % kQStages;
        mbar_wait(&empty[st], ((i / kQStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kTile);
        for (int x = 0; x < kBoxes; ++x) {
          tma_load_4d(Ks + st * kTile + x * kBoxBytes, &tk, &full[st], x * kBox, g, kt * kBN, b);
          tma_load_4d(Vs + st * kTile + x * kBoxBytes, &tv, &full[st], x * kBox, g, kt * kBN, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int t = lane & 3;
    const int row_lo = q0 + 64 * c;                    // this warpgroup's rows
    const int r0 = row_lo + 16 * warp + (lane >> 2);   // this thread's rows: r0 and r0 + 8
    const uint32_t q_base = smem_addr(Qs) + c * 64 * 128;
    const uint32_t o_base = smem_addr(Os) + c * 64 * 128;

    // Per row: lse in base 2, Delta = rowsum(dO * o) (the quad that shares
    // the row takes a quarter of its columns each, 16-byte loads), and the
    // keys it may see, [k_min, k_max].  The quad's first thread stores lse
    // and Delta for the dK / dV kernel, which runs after this one.
    float lse2[2], dl[2];
    int k_min[2], k_max[2];
    const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(a.o) + b * a.osb + h * a.osh;
    const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dsb + h * a.dsh;
    const int64_t bh = static_cast<int64_t>(b) * a.H + h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      k_min[half] = a.window > 0 ? row - a.window + 1 : 0;
      k_max[half] = a.causal ? min(row, Sk - 1) : Sk - 1;
      float acc = 0.f;
      if (row < Sq) {
        const uint4* op = reinterpret_cast<const uint4*>(ob + row * a.oss + t * (D / 4));
        const uint4* dp = reinterpret_cast<const uint4*>(db + row * a.dss + t * (D / 4));
#pragma unroll
        for (int u = 0; u < D / 32; ++u) {
          const uint4 x = op[u], y = dp[u];
          const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(x2[e]), yf = __bfloat1622float2(y2[e]);
            acc = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, acc));
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dl[half] = acc;
      lse2[half] = row < Sq ? a.lse[bh * Sq + row] * kLog2e : 0.f;
      if (t == 0 && row < Sq) {
        a.scratch[bh * a.ldl + row] = acc;
        a.scratch[(static_cast<int64_t>(a.B) * a.H + bh) * a.ldl + row] = lse2[half];
      }
    }
    float dq[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;

    mbar_wait(q_full, 0);
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int st = i % kQStages;
      const int k0 = kt * kBN;
      mbar_wait(&full[st], (i / kQStages) & 1);
      if (row_lo >= Sq || (a.causal && k0 > row_lo + 63) ||
          (a.window > 0 && k0 + kBN - 1 <= row_lo - a.window)) {
        mbar_arrive(&empty[st]);
        continue;
      }
      const uint32_t k_addr = fresh(smem_addr(Ks) + st * kTile);
      const uint32_t v_addr = fresh(smem_addr(Vs) + st * kTile);
      const uint32_t q_addr = fresh(q_base), o_addr = fresh(o_base);

      // S = Q K^T, then dP = dO V^T, as two groups.
      float s[kBN / 2], dp[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
        wgmma_ss_m64n128(s, sw128_desc(q_addr + off, 16), sw128_desc(k_addr + off, 16), ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * kBoxBytes + (ks % 4) * 32;
        wgmma_ss_m64n128(dp, sw128_desc(o_addr + off, 16), sw128_desc(v_addr + off, 16), ks > 0);
      }
      wgmma_commit();

      // P = exp2(S * scale_log2 - lse2[row]) while dP runs; s[4j + 2*half + e]
      // is row r0 + 8*half, key k0 + 8j + 2t + e.  Rows past Sq are not
      // stored, so only keys need the mask's ragged edge (Sk).
      const bool need_mask = k0 + kBN > Sk || (a.causal && k0 + kBN - 1 > row_lo) ||
                             (a.window > 0 && k0 <= row_lo + 63 - a.window);
      wgmma_wait<1>();
      pin<kBN / 2>(s);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * half + e];
            x = ex2(fmaf(x, a.scale_log2, -lse2[half]));
            const int kpos = k0 + 8 * j + 2 * t + e;
            if (need_mask && (kpos < k_min[half] || kpos > k_max[half])) x = 0.f;
          }

      // dS = P (dP - Delta[row]), in bf16 the A fragment of dQ += dS K.
      wgmma_wait<0>();
      pin<kBN / 2>(dp);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * half + e;
            dp[idx] = s[idx] * (dp[idx] - dl[half]);
          }
      uint32_t da[kBN / 4];
      to_a<kBN>(da, dp);

      // dQ += dS K: K's 16 key rows of step kk are 2048 bytes on, its second
      // 64-column box one box further (the LBO).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs_nd<D>(dq, &da[4 * kk], sw128_desc(k_addr + kk * 16 * 128, kBoxBytes));
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(dq);
      pin<kBN / 4>(da);
      mbar_arrive(&empty[st]);
    }

    // Epilogue: dQ * scale in bf16, rows past Sq not stored.
    const int64_t ld = static_cast<int64_t>(a.H) * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(a.dq) + (static_cast<int64_t>(b) * Sq * a.H + h) * D,
                  ld, dq, r0, Sq, a.scale);
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

  load_tile_f32<D>(Ks, static_cast<const float*>(a.k) + b * a.ksb + g * a.ksh, a.kss, k0, a.Sk);
  load_tile_f32<D>(Vs, static_cast<const float*>(a.v) + b * a.vsb + g * a.vsh, a.vss, k0, a.Sk);
  float dk[NJ], dv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dk[j] = dv[j] = 0.f;

  int qt_first, qt_end;
  query_tiles(a, k0, kFT, &qt_first, &qt_end);
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.Sq;
    const float* drow = a.delta + (static_cast<int64_t>(b) * a.H + h) * a.Sq;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kFT;
      __syncthreads();
      load_tile_f32<D>(Qs, static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh, a.qss, q0, a.Sq);
      load_tile_f32<D>(Os, static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh, a.dss, q0,
                       a.Sq);
      for (int i = threadIdx.x; i < kFT; i += blockDim.x) {
        const bool in = q0 + i < a.Sq;
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
  if (k0 + key < a.Sk) {
    const int64_t off = ((static_cast<int64_t>(b) * a.Sk + k0 + key) * a.KV + g) * D + c8;
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

  load_tile_f32<D>(Qs, static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh, a.qss, q0, a.Sq);
  load_tile_f32<D>(Os, static_cast<const float*>(a.dout) + b * a.dsb + h * a.dsh, a.dss, q0, a.Sq);
  for (int i = threadIdx.x; i < kFT; i += blockDim.x) {
    const int64_t idx = (static_cast<int64_t>(b) * a.H + h) * a.Sq + q0 + i;
    const bool in = q0 + i < a.Sq;
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
    load_tile_f32<D>(Ks, static_cast<const float*>(a.k) + b * a.ksb + g * a.ksh, a.kss, k0, a.Sk);
    load_tile_f32<D>(Vs, static_cast<const float*>(a.v) + b * a.vsb + g * a.vsh, a.vss, k0, a.Sk);
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
  if (q0 + row < a.Sq) {
    float* dqb = static_cast<float*>(a.dq);
    const int64_t off = ((static_cast<int64_t>(b) * a.Sq + q0 + row) * a.H + h) * D + c8;
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
// 4-d map (D, heads, S, B) read in boxes of 64 columns x 1 head x `rows`
// rows, 128-byte swizzled.
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, int64_t sb, int64_t ss, int64_t sh, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (2 B H, Sq) fp32 rows of Delta and lse (row stride ldl) in boxes of
// kBM columns.
bool make_rows_map(EncodeTiledFn enc, CUtensorMap* map, const float* ptr, int rows, int S,
                   int ldl) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldl) * 4};
  const cuuint32_t box[2] = {kBM, 1};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA addresses a base on 16 bytes and strides that are multiples of 16
// bytes, below 2^40; the wrapper copies a tensor otherwise.
bool tma_ok(const void* p, int64_t s0, int64_t s1, int64_t s2) {
  const int64_t lim = int64_t(1) << 39;  // elements of 2 bytes
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 > 0 && s1 > 0 && s2 > 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0 && s0 < lim && s1 < lim && s2 < lim;
}

// dQ first (it also stores every row's Delta and lse in base 2), then dK
// and dV, which read them.
template <int D>
cudaError_t launch_bf16(const BwdArgs& a, cudaStream_t st) {
  if (!tma_ok(a.q, a.qsb, a.qss, a.qsh) || !tma_ok(a.k, a.ksb, a.kss, a.ksh) ||
      !tma_ok(a.v, a.vsb, a.vss, a.vsh) || !tma_ok(a.o, a.osb, a.oss, a.osh) ||
      !tma_ok(a.dout, a.dsb, a.dss, a.dsh)) {
    return cudaErrorInvalidValue;
  }
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int ldl = (a.Sq + 3) / 4 * 4;  // rows of Delta and lse on 16 bytes, as TMA reads them
  const WsArgs w{a.o,   a.dout, a.lse, a.delta, a.dq,  a.dk,  a.dv,     a.osb,    a.oss,
                 a.osh, a.dsb,  a.dss, a.dsh,   a.B,   a.Sq,  a.Sk,     a.H,      a.KV,
                 ldl,   a.causal, a.window, a.scale, a.scale * kLog2e};
  CUtensorMap tq, tdo, tk, tv, tld;
  if (!make_map(enc, &tq, a.q, a.B, a.Sq, a.H, D, a.qsb, a.qss, a.qsh, kBN) ||
      !make_map(enc, &tdo, a.dout, a.B, a.Sq, a.H, D, a.dsb, a.dss, a.dsh, kBN) ||
      !make_map(enc, &tk, a.k, a.B, a.Sk, a.KV, D, a.ksb, a.kss, a.ksh, kBN) ||
      !make_map(enc, &tv, a.v, a.B, a.Sk, a.KV, D, a.vsb, a.vss, a.vsh, kBN)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem_q = dq_smem_bytes<D>();
  constexpr int smem_kv = dkdv_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma<D><<<dim3(a.B * a.H, (a.Sq + kBN - 1) / kBN), kWsThreads, smem_q, st>>>(
      tq, tdo, tk, tv, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The dK / dV kernel streams 64-row tiles of q and dO.
  if (!make_map(enc, &tq, a.q, a.B, a.Sq, a.H, D, a.qsb, a.qss, a.qsh, kBM) ||
      !make_map(enc, &tdo, a.dout, a.B, a.Sq, a.H, D, a.dsb, a.dss, a.dsh, kBM) ||
      !make_rows_map(enc, &tld, a.delta, 2 * a.B * a.H, a.Sq, ldl)) {
    return cudaErrorInvalidValue;
  }
  bwd_dkdv_wgmma<D><<<dim3(a.B * a.KV, (a.Sk + kBN - 1) / kBN), kWsThreads, smem_kv, st>>>(
      tq, tdo, tk, tv, tld, w);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const BwdArgs& a, cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(a.B) * a.Sq * a.H;
  cudaError_t err = run(bwd_delta<D>, dim3(static_cast<unsigned>((rows + 7) / 8)), 256, 0, st, a);
  if (err != cudaSuccess) return err;
  err = run(bwd_dkdv_f32<D>, dim3(a.B * a.KV, (a.Sk + kFT - 1) / kFT), kFThreads, f32_smem<D>(),
            st, a);
  if (err != cudaSuccess) return err;
  return run(bwd_dq_f32<D>, dim3(a.B * a.H, (a.Sq + kFT - 1) / kFT), kFThreads, f32_smem<D>(), st,
             a);
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* scratch, void* dq, void* dk, void* dv,
    int B, int Sq, int Sk, int H, int KV, int D,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss, int64_t osh,
    int64_t dsb, int64_t dss, int64_t dsh,
    int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      static_cast<int64_t>(B) * H > 0x7fffffff || (Sq + kFT - 1) / kFT > 65535 ||
      (Sk + kFT - 1) / kFT > 65535 ||
      (dtype != 0 && dtype != 1) || (D != 64 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{q,   k,   v,   o,   dout, lse, scratch, dq,  dk,  dv,  B,   Sq,  Sk,  H,
                  KV,  qsb, qss, qsh, ksb,  kss, ksh,     vsb, vss, vsh, osb, oss, osh, dsb,
                  dss, dsh, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(D == 64 ? launch_bf16<64>(a, st) : launch_bf16<128>(a, st));
  }
  return static_cast<int>(D == 64 ? launch_f32<64>(a, st) : launch_f32<128>(a, st));
}
