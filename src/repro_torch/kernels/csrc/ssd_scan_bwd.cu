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
// Precision: every product runs on the tensor cores in 3xTF32.  An fp32
// operand a is split into big = tf32(a) and small = tf32(a - big), both
// rounded to nearest with ties away (cvt.rna.tf32.f32's rounding, done with
// an integer add and a mask); a product is big.big in one fp32 accumulator
// and the small terms small.big + big.small in another, added to the first
// last, all on mma.sync m16n8k8.  A bf16 operand is exact in TF32, so a
// product with B or C (R, dC, dB's dG^T C) takes two passes, and so do dM
// and the states' term of dB when x is bf16: dt and the decay depend on s
// alone and are applied after the product, dM = dt[s] o (dy x^T) and
// decay o (xdt dst) = (dt decay)[s] o (x dst).  G = C B^T is
// one bf16 mma.sync m16n8k16 for bf16 B and C (the products exact in fp32),
// 3xTF32 for fp32 ones.  A single TF32 pass would miss the tests' 2e-5 of
// scale by 6-21x (tests/test_torch_ssd.py emulates both on the CPU);
// 3xTF32 holds it with a margin near fp32's own.
//
// What bounds it: at mamba2-130m (B 4, L 2048, H 24, P 64, N 128, Q 256,
// bf16 x, B and C), counted where the decay is not zero (s <= l) as the
// forward's bound is, per (b, c, h) dM takes Q(Q+1)P in 2 passes and M^T dy
// Q(Q+1)P in 3, R and the states' term of dB 2QNP each in 2; per (b, c) dC
// and dG^T C Q(Q+1)N each in 2: 30.1 GFLOP of TF32 passes, 0.061 ms at 495
// TFLOP/s, against ~137 MB moved, 0.041 ms: operations.  (As fp32 FMAs the
// same products are 13.7 GFLOP, 0.205 ms at 67 TFLOP/s.)
//
// The design: three kernels in order on the stream.  Every output element
// and every scratch element has exactly one writer and no atomics are used,
// so two launches give equal bits.
//   1. bwd_heads: a block of 16 warps per (b, c, 64-position s-tile, group
//      of 3 heads; 1 head with fp32 B and C), heaviest (first s-tile)
//      first, one block an SM (212 KB of shared memory at bf16).  A warp
//      owns a 16 x 16 piece of each 64 x 64 product.  The groups of one
//      (b, c, s-tile) form a thread-block cluster (2 blocks where that
//      leaves at most 4 partials: mamba2-130m's 24 heads make 4 clusters
//      of 2; more blocks, up to 8, beyond), which sums the groups' partial
//      dG tiles and states' terms on chip: each block leaves its partial
//      in its own shared memory, and after a cluster barrier each rank
//      adds its slice of every rank's partial over distributed shared
//      memory in rank order and writes the sum to scratch, the slice's one
//      writer.  Kernel 2 adds the clusters' sums.
//        Phase 1, per head: the dst tile (cp.async, the next head's in
//      flight) split once into (big, small) pairs; R = B dst^T, dxdt =
//      decay o R and u in registers; the states' term (dt decay) o (x dst)
//      summed over the group in registers.
//        Phase 2, per l-tile at and below the s-tile: G = C B^T (C's next
//      tile in flight); off the diagonal the decay factors into a term of
//      l and one of s (no exponential an element); per head the dy tile
//      (the next head's in flight) split once into pairs, dM = dt o (dy
//      x^T), Lm, M and dT elementwise in registers, dG summed over the
//      group in shared memory, M split into pairs, dxdt += M^T dy; dT's
//      row sums written per s-tile and its column sums kept.  On the
//      diagonal tile the warps whose piece lies above it skip G, dM and
//      the elementwise pass, and M^T dy starts at the warp's own 16
//      positions; the warps' pieces are spread so that each SM sub-
//      partition gets an even share of that triangle.
//        Last, dx = dxdt dt, rowsum(dxdt o x) into ddt, colsum(dT) + u and
//      the tile's sum of u into scratch.
//   2. bwd_chunk, 8 warps a block: a warp per (b, c, h) chunk sums d a from
//      the partials, runs the reverse cumulative sum, finishes ddt and
//      writes the chunk's share of dA; dB tiles (b, c, s-tile) are the
//      states' term plus dG^T C over the l-tiles at and below, dC tiles
//      (b, c, l-tile) dG B over the s-tiles at and above, with the next
//      tiles in flight.
//   3. bwd_dA: dA[h] = the chunks' shares summed in (b, c) order.  Nothing
//      is left for the host after the launch.
// Scratch (41.7 MB at mamba2-130m's shape): the clusters' dG tiles (lower
// ones only) and states' terms, dT's row sums a s-tile, the column sums,
// u's sums, dA's shares.
// What holds it back: shared-memory bandwidth, not the tensor cores.  Each
// warp loads its own fragments of a 16 x 16 piece, so every operand is read
// by four warps, and a split one as 8-byte (big, small) pairs: a k-step of
// M^T dy moves 16 wavefronts of shared memory for 6 mma.sync, one of dM or
// phase 1's products 12 for 4.  Larger warp pieces would need more
// registers than 16 warps at 128 have; wgmma would read the operands from
// shared memory once a warpgroup, but tf32 wgmma wants both K-major in
// split planes, which this kernel's layouts (dy and dst each serve as both
// a row- and a column-major operand) and shared memory do not hold.
// Between the products every head still takes three block-wide barriers,
// a split pass and an elementwise pass, and each l-tile a cluster barrier.
//
// Limits, checked on the host: P <= 64, N <= 128, both multiples of 4, Q even;
// x, B, C and dy with bases and strides that allow reads of 4 elements and
// their last axis contiguous (the wrapper copies one otherwise); kernel 2's
// shared memory (32 Q bytes) within the card's 227 KB.
//
// Interface: plain C, loaded with ctypes.  ssd_scan_bwd_scratch_floats
// gives the fp32 scratch the launch needs.  ssd_scan_bwd_launch returns
// cudaGetLastError() after the last launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take, before any launch.
// Launches on the given stream and does not synchronize.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // threads a bwd_chunk block
constexpr int kHT = 512;         // threads a bwd_heads block
constexpr int kT = 64;           // positions per tile
constexpr int kMaxCS = 8;        // blocks per cluster (portable)
constexpr int kParts = 4;        // partials a cluster size of 2 may leave
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kXS = kMaxP + 4;   // row stride (floats) of x and raw dy tiles
constexpr int kPS = kT + 4;      // row stride (pairs) of the split dy and M tiles
constexpr int kMS = kT + 8;      // row stride of the dG partial and bwd_chunk's dG tiles
constexpr int kDS = kMaxN + 4;   // row stride of dst (floats and pairs), fp32 B / C tiles
constexpr int kWS = kMaxN + 8;   // row stride of bf16 B / C tiles, and of bwd_chunk's

// Heads a bwd_heads block: 3 with bf16 B and C, 1 with fp32 ones (whose
// B and C tiles take twice the shared memory).
constexpr int heads_per_block(int dtype) { return dtype == 1 ? 3 : 1; }

template <typename T>
struct BCStride {
  static constexpr int v = sizeof(T) == 2 ? kWS : kDS;
};

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
  float* dA;          // (H,)
  void* dB;           // (B, L, N)
  void* dC;           // (B, L, N)
  // scratch
  float* dGp;    // (B, C, NP, nT (nT + 1) / 2, 64, 64): lower tiles (lt, st), st <= lt
  float* SBp;    // (B, C, NP, nT, 64, 128): the states' term of dB
  float* rowp;   // (B, C, H, nT, Q)
  float* cpart;  // (B, C, H, Q)
  float* usum;   // (B, C, H, nT)
  float* dAp;    // (B, C, H): each chunk's share of dA
  int B, L, H, P, N, Q, C, nT, NP, CS;
  int64_t xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl, ysb, ysc, ysh, ysl;
};

__host__ __device__ int64_t round4(int64_t n) { return (n + 3) & ~static_cast<int64_t>(3); }

// Head groups, cluster parts and the cluster size for H heads.
// Clusters of 2 where that leaves at most kParts partials (with a block an
// SM, the card fits fewer clusters of 8 than it has SMs for), larger ones
// up to kMaxCS beyond.
int n_groups(int H, int dtype) { return (H + heads_per_block(dtype) - 1) / heads_per_block(dtype); }
int cluster_size(int H, int dtype) {
  const int g = n_groups(H, dtype), cs = (g + kParts - 1) / kParts;
  return cs < 2 ? (g < 2 ? g : 2) : (cs > kMaxCS ? kMaxCS : cs);
}
int n_parts(int H, int dtype) {
  return (n_groups(H, dtype) + cluster_size(H, dtype) - 1) / cluster_size(H, dtype);
}

// Offsets (floats) of the scratch's parts, each on 16 bytes.
struct Scratch {
  int64_t dGp, SBp, rowp, cpart, usum, dAp, total;
};

Scratch scratch_layout(int B, int L, int H, int Q, int dtype) {
  const int64_t C = L / Q, nT = (Q + kT - 1) / kT, NP = n_parts(H, dtype), BC = B * C;
  Scratch s;
  s.dGp = 0;
  s.SBp = s.dGp + BC * NP * (nT * (nT + 1) / 2) * kT * kT;
  s.rowp = s.SBp + BC * NP * nT * kT * kMaxN;
  s.cpart = s.rowp + round4(BC * H * nT * Q);
  s.usum = s.cpart + round4(BC * H * Q);
  s.dAp = s.usum + round4(BC * H * nT);
  s.total = s.dAp + round4(BC * H);
  return s;
}

// ---------------------------------------------------------------------------
// Loads, shared-memory operands, and 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// Four elements as loaded (raw4) and as floats (unpack4): loads issued
// unconditionally, from a valid address, so that several stay in flight.
__device__ __forceinline__ float4 raw4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 raw4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ float4 unpack4(float4 v) { return v; }
__device__ __forceinline__ float4 unpack4(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// cp.async of 4 elements (16 bytes of fp32, 8 of bf16), zero-filled when !in.
__device__ __forceinline__ void cp4(float* d, const float* s, bool in) {
  const uint32_t da = static_cast<uint32_t>(__cvta_generic_to_shared(d));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(da), "l"(s), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(__nv_bfloat16* d, const __nv_bfloat16* s, bool in) {
  const uint32_t da = static_cast<uint32_t>(__cvta_generic_to_shared(d));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(da), "l"(s), "r"(in ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Rows [0, 64) of a slab (row r at src + r * ls, `width` elements) into
// tile[r * ts + col] for col < COLS (a multiple of 4), by cp.async; zero
// past `nrows` rows or `width` columns.
template <int COLS, typename T>
__device__ __forceinline__ void cp_tile(T* tile, int ts, const T* src, int64_t ls, int nrows,
                                        int width) {
  constexpr int vpr = COLS / 4;
  for (int i = threadIdx.x; i < kT * vpr; i += blockDim.x) {
    const int r = i / vpr, v = 4 * (i % vpr);
    const bool in = r < nrows && v < width;
    cp4(tile + r * ts + v, in ? src + r * ls + v : src, in);
  }
}

// Cluster barrier halves: every thread of every block of the cluster
// arrives, then waits; shared-memory writes before the arrive are seen by
// every block after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_scalar(float* d, const float* s, bool in) {
  const uint32_t da = static_cast<uint32_t>(__cvta_generic_to_shared(d));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(da), "l"(s), "r"(in ? 4 : 0)
               : "memory");
}

// big = tf32(a) and small = tf32(a - big), both rounded to nearest with ties
// away from zero, as cvt.rna.tf32.f32 rounds a finite value (cvt.rna itself
// compiles to a guarded sequence twice as long: it also handles inf).
__device__ __forceinline__ uint32_t rna_tf32(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = rna_tf32(__float_as_uint(a));
  small = rna_tf32(__float_as_uint(a - __uint_as_float(big)));
}
__device__ __forceinline__ uint2 split2(float a) {
  uint2 r;
  split(a, r.x, r.y);
  return r;
}

// Operands of mma3, element (r, c) at p[r * RS + c * CS] of a shared-memory
// tile, as a (big, small) pair.  Tile: fp32 values split on use (kSplit),
// or bf16 ones, exact in TF32 (no small part).  Pairs: split once, when the
// tile was written.
template <typename T, int RS, int CS>
struct Tile {
  static constexpr bool kSplit = sizeof(T) == 4;
  const T* p;
  __device__ __forceinline__ void get(int r, int c, uint32_t& big, uint32_t& small) const {
    const float v = to_f(p[r * RS + c * CS]);
    if constexpr (kSplit) {
      split(v, big, small);
    } else {
      big = __float_as_uint(v);
      small = 0u;
    }
  }
};

// fp32 values widened from bf16, exact in TF32: no small part.
template <int RS, int CS>
struct Exact {
  static constexpr bool kSplit = false;
  const float* p;
  __device__ __forceinline__ void get(int r, int c, uint32_t& big, uint32_t& small) const {
    big = __float_as_uint(p[r * RS + c * CS]);
    small = 0u;
  }
};

// x's tile in shared memory (fp32) as an operand: split unless it came from bf16.
template <typename T, int RS, int CS>
using XOp = std::conditional_t<sizeof(T) == 2, Exact<RS, CS>, Tile<float, RS, CS>>;

template <int RS, int CS>
struct Pairs {
  static constexpr bool kSplit = true;
  const uint2* p;
  __device__ __forceinline__ void get(int r, int c, uint32_t& big, uint32_t& small) const {
    const uint2 v = p[r * RS + c * CS];
    big = v.x;
    small = v.y;
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += sum_{k0 <= k < K} A(m, k) B(k, n) for the warp's 16 x 8 NJ piece: rows
// m0 + g and m0 + g + 8, columns n0 + 8 j + 2 t and + 1 (g = lane / 4, t =
// lane % 4; acc[j][e] is row m0 + g + 8 (e / 2), column n0 + 8 j + 2 t +
// e % 2).  k0 and K are multiples of 8.  3xTF32 on mma.sync m16n8k8: the small
// terms, small(A) big(B) and big(A) small(B) where an operand has a small
// part, go into an accumulator of their own, big(A) big(B) into acc, and
// the small terms' sum is added to acc last.  Two accumulators keep the
// three passes of a k step from waiting on each other.
template <int NJ, class FA, class FB>
__device__ __forceinline__ void mma3(float (&acc)[NJ][4], const FA& A, const FB& B, int m0, int n0,
                                     int K, int k0 = 0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr bool kSmall = FA::kSplit || FB::kSplit;
  float sm[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm[j][e] = 0.f;
#pragma unroll 1
  for (int k = k0; k < K; k += 8) {
    uint32_t ab[4], as[4];
    A.get(m0 + g, k + t, ab[0], as[0]);
    A.get(m0 + g + 8, k + t, ab[1], as[1]);
    A.get(m0 + g, k + t + 4, ab[2], as[2]);
    A.get(m0 + g + 8, k + t + 4, ab[3], as[3]);
    uint32_t bb[NJ][2], bs[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      B.get(k + t, n0 + 8 * j + g, bb[j][0], bs[j][0]);
      B.get(k + t + 4, n0 + 8 * j + g, bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if constexpr (FA::kSplit) mma_tf32(sm[j], as, bb[j][0], bb[j][1]);
      mma_tf32(acc[j], ab, bb[j][0], bb[j][1]);
    }
    if constexpr (FB::kSplit) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_tf32(sm[j], ab, bs[j][0], bs[j][1]);
    }
  }
  if constexpr (kSmall) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += sm[j][e];
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The warp's 16 x 8 NJ piece of the score tile G[l][s] = C[l] . B[s] (rows
// m0, columns n0).  bf16: mma.sync m16n8k16 (exact products, fp32 sums), the
// tiles zero past N up to a multiple of 16; fp32: 3xTF32.
template <int NJ>
__device__ __forceinline__ void scores(float (&G)[NJ][4], const __nv_bfloat16* Ct,
                                       const __nv_bfloat16* Bt, int N, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < N; k += 16) {
    uint32_t a[4];
    a[0] = ld32(&Ct[(m0 + g) * kWS + k + 2 * t]);
    a[1] = ld32(&Ct[(m0 + g + 8) * kWS + k + 2 * t]);
    a[2] = ld32(&Ct[(m0 + g) * kWS + k + 8 + 2 * t]);
    a[3] = ld32(&Ct[(m0 + g + 8) * kWS + k + 8 + 2 * t]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const __nv_bfloat16* brow = &Bt[(n0 + 8 * j + g) * kWS + k + 2 * t];
      mma_bf16(G[j], a, ld32(brow), ld32(brow + 8));
    }
  }
}
template <int NJ>
__device__ __forceinline__ void scores(float (&G)[NJ][4], const float* Ct, const float* Bt, int N,
                                       int m0, int n0) {
  mma3(G, Tile<float, kDS, 1>{Ct}, Tile<float, 1, kDS>{Bt}, m0, n0, (N + 7) & ~7);
}

// A 64 x `cols` fp32 tile (row stride rs) split into (big, small) pairs
// (row stride ps): 4 elements a thread and step.
__device__ __forceinline__ void split_tile(uint2* out, int ps, const float* in, int rs, int cols) {
  const int vpr = cols / 4;
  for (int i = threadIdx.x; i < kT * vpr; i += blockDim.x) {
    const int r = i / vpr, c = 4 * (i % vpr);
    const float4 v = *reinterpret_cast<const float4*>(in + r * rs + c);
    const uint2 p0 = split2(v.x), p1 = split2(v.y), p2 = split2(v.z), p3 = split2(v.w);
    uint4* o = reinterpret_cast<uint4*>(out + r * ps + c);
    o[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
    o[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
  }
}

// Sum over a row's 4 lanes (lanes 4 g .. 4 g + 3) and over a column's 8.
__device__ __forceinline__ float sum_row(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float sum_col(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// ---------------------------------------------------------------------------
// 1. Per (b, c, s-tile, group of heads); a cluster over the groups.
// ---------------------------------------------------------------------------

// a_cs of nh heads (rows Q apart from acs) at the l-tile lt, into v[h][l]
// by cp.async; zero past the chunk and nh (`safe`: any valid address).
template <int HG>
__device__ __forceinline__ void load_acs_tile(float* v, const float* acs, const float* safe, int Q,
                                              int nh, int lt) {
  const int l0 = lt * kT, nl = min(kT, Q - l0);
  for (int i = threadIdx.x; i < HG * kT; i += blockDim.x) {
    const int h = i / kT, l = i % kT;
    const bool in = h < nh && l < nl;
    cp_scalar(v + i, in ? acs + h * Q + l0 + l : safe, in);
  }
}

// acc = d[h] and d[h] = acc for a head index known only at run time, with
// d kept in registers (every k a constant index).
template <int HG, int NJ>
__device__ __forceinline__ void pick(float (&acc)[NJ][4], const float (&d)[HG][NJ][4], int h) {
#pragma unroll
  for (int k = 0; k < HG; ++k)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k == h) acc[j][e] = d[k][j][e];
}
template <int HG, int NJ>
__device__ __forceinline__ void put(float (&d)[HG][NJ][4], const float (&acc)[NJ][4], int h) {
#pragma unroll
  for (int k = 0; k < HG; ++k)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k == h) d[k][j][e] = acc[j][e];
}

// Shared memory (floats from the start): per head a_cs at the s-tile, at the
// l-tile (two buffers), dt at the s-tile, the decay (phase 1) or the off-
// diagonal decay factors e and f (phase 2), colsum(dT) and u; warp partials
// of row and column sums; the heads' x tiles (fp32); the dG partial; a region
// that holds, in phase 1, a raw dst tile and its split pairs, then the
// states' partial, and in phase 2 a raw dy tile, dy's and M's pairs and the
// score tile; the B tile and the C tile.
template <typename T>
struct HeadsSmem {
  static constexpr int HG = heads_per_block(sizeof(T) == 2 ? 1 : 0), V = HG * kT;
  static constexpr int acss = 0, acsl = acss + V, dts = acsl + 2 * V, ef = dts + V, decs = ef,
                       colacc = ef + 2 * V, uacc = colacc + V, rowred = uacc + V,
                       colred = rowred + 4 * kT, xt = colred + 4 * kT, red = xt + HG * kT * kXS,
                       region = red + kT * kMS;
  // phase 1: raw dst [64][kDS] floats, then its pairs [64][kDS]
  static constexpr int dst_raw = 0, dst_pairs = kT * kDS;
  // phase 2: raw dy [64][kXS] floats, then dy's and M's pairs [64][kPS] each,
  // then the score tile G [64][64] (each thread's own elements, swizzled)
  static constexpr int dy_raw = 0, dy_pairs = kT * kXS, m_pairs = dy_pairs + 2 * kT * kPS,
                       g_tile = m_pairs + 2 * kT * kPS;
  static constexpr int region_floats =
      3 * kT * kDS > g_tile + kT * kT ? 3 * kT * kDS : g_tile + kT * kT;
  static constexpr int tile_floats = kT * BCStride<T>::v * static_cast<int>(sizeof(T)) / 4;
  static constexpr int bt = region + region_floats, ct = bt + tile_floats, total = ct + tile_floats;
};

// A thread's own element (l, s) of G and of the dG partial: G's columns
// swizzled by row so that a warp's float2 accesses hit distinct banks.
__device__ __forceinline__ int gidx(int l, int s) { return l * kT + (s ^ ((l & 3) << 3)); }
__device__ __forceinline__ int ridx(int l, int s) { return l * kMS + s; }

// 16 warps: warp w owns rows 16 wm .. + 15 and columns 16 wn .. + 15 of a
// 64 x 64 product (NJ = 2), or columns 32 wn .. + 31 of the 64 x 128 one,
// with wm = w / 4 and wn = (w - wm) % 4.  A warp runs on the SM's sub-
// partition w % 4 = (wm + wn) % 4, so each sub-partition holds one warp of
// every row tile wm and the diagonal tile's triangle spreads over the four
// evenly (3, 2, 3 and 2 of its 10 pieces; by rows, 4 to 1).
template <typename T>
__global__ void __launch_bounds__(kHT, 1) bwd_heads(Args a) {
  using S = HeadsSmem<T>;
  constexpr int kHG = S::HG;
  constexpr int kTS = BCStride<T>::v;
  constexpr int NJ = 2;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* acss = sm + S::acss;
  float* decs = sm + S::decs;
  float* dts = sm + S::dts;
  float* ef = sm + S::ef;          // [2][kHG][64]: e at the l-tile, f at the s-tile
  float* colacc = sm + S::colacc;
  float* uacc = sm + S::uacc;
  float* rowred = sm + S::rowred;  // [4][64]: a row's partial per column-quarter warp
  float* colred = sm + S::colred;  // [4][64]: a column's partial per row-quarter warp
  float* xt = sm + S::xt;          // [kHG][64][kXS]: x of the heads' s-tiles
  float* red = sm + S::red;        // [64][kMS]: this block's dG partial
  float* region = sm + S::region;
  float* dst_raw = region + S::dst_raw;
  uint2* dstP = reinterpret_cast<uint2*>(region + S::dst_pairs);  // [p][n]
  float* dy_raw = region + S::dy_raw;
  uint2* dyP = reinterpret_cast<uint2*>(region + S::dy_pairs);    // [l][p]
  uint2* MtP = reinterpret_cast<uint2*>(region + S::m_pairs);     // [l][s]
  float* Gt = region + S::g_tile;  // G, each thread's own elements
  T* Bt = reinterpret_cast<T*>(sm + S::bt);
  T* Ct = reinterpret_cast<T*>(sm + S::ct);

  const int Q = a.Q, P = a.P, N = a.N, nT = a.nT, CS = a.CS, BC = a.B * a.C;
  const int rank = static_cast<int>(blockIdx.x) % CS;  // the block's rank in its cluster
  int idx = static_cast<int>(blockIdx.x) / CS;
  const int part = idx % a.NP;
  idx /= a.NP;
  const int bc = idx % BC, st = idx / BC;
  const int b = bc / a.C, c = bc % a.C;
  const int h0 = (part * CS + rank) * kHG;
  const int nh = max(0, min(kHG, a.H - h0));
  const int s0 = st * kT, ns = min(kT, Q - s0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = (warp - wm) & 3, m0 = 16 * wm, n0 = 16 * wn;
  const int kP = (P + 7) & ~7, kN = (N + 7) & ~7;
  const int64_t row0 = static_cast<int64_t>(c) * Q;
  const int64_t bch0 = static_cast<int64_t>(bc) * a.H + h0;  // (b, c, h0)
  const int64_t bcp = static_cast<int64_t>(bc) * a.NP + part;
  const T* xb0 = static_cast<const T*>(a.x);  // a valid address for loads that are masked
  const T* xb = xb0 + b * a.xsb + (row0 + s0) * a.xsl + h0 * a.xsh;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bsb + row0 * a.bsl;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.csb + row0 * a.csl;
  const float* dyb = a.dy + b * a.ysb + c * a.ysc + h0 * a.ysh;
  cg::cluster_group cluster = cg::this_cluster();

  // The B tile and the first head's dst in flight while the per-head
  // vectors and the x tiles load.
  cp_tile<kMaxN>(Bt, kTS, Bb + s0 * a.bsl, a.bsl, ns, N);
  if (nh > 0) cp_tile<kMaxN>(dst_raw, kDS, a.dst + bch0 * P * N, N, P, N);
  cp_commit();
  // x of the heads' s-tiles, all loads in flight at once.
  constexpr int kXV = kHG * kT * (kMaxP / 4) / kHT;
  decltype(raw4(xb)) xv[kXV];
#pragma unroll
  for (int k = 0; k < kXV; ++k) {
    const int i = tid + k * kHT, h = i / (kT * (kMaxP / 4)), r = i % (kT * (kMaxP / 4));
    const int s = r / (kMaxP / 4), p = 4 * (r % (kMaxP / 4));
    xv[k] = raw4(h < nh && s < ns && p < P ? xb + h * a.xsh + s * a.xsl + p : xb0);
  }
  for (int i = tid; i < S::V; i += kHT) {
    const int h = i / kT, s = i % kT;
    const bool in = h < nh && s < ns;
    const float ac = in ? a.acs[(bch0 + h) * Q + s0 + s] : 0.f;
    const float al = in ? a.acs[(bch0 + h) * Q + Q - 1] : 0.f;
    acss[i] = ac;
    decs[i] = in ? expf(al - ac) : 0.f;
    dts[i] = in ? a.dt[b * a.dsb + (row0 + s0 + s) * a.dsl + (h0 + h) * a.dsh] : 0.f;
    colacc[i] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < kXV; ++k) {
    const int i = tid + k * kHT, h = i / (kT * (kMaxP / 4)), r = i % (kT * (kMaxP / 4));
    const int s = r / (kMaxP / 4), p = 4 * (r % (kMaxP / 4));
    *reinterpret_cast<float4*>(&xt[(h * kT + s) * kXS + p]) =
        h < nh && s < ns && p < P ? unpack4(xv[k]) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Phase 1, per head: R = B dst^T, dxdt = decay o R, u, and the states'
  // term of dB, decay o (xdt dst) = (dt decay) o (x dst), summed over the
  // group (sb: the warp's 16 x 32 piece of the 64 x 128 tile, columns
  // 32 wn + 8 j + ...).  dt and the decay depend on s alone, so the
  // product takes x as it is: exact in TF32 when x is bf16.
  float dxdt[kHG][NJ][4];
  float sb[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[j][e] = 0.f;
#pragma unroll
  for (int h = 0; h < kHG; ++h)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxdt[h][j][e] = 0.f;
#pragma unroll 1
  for (int h = 0; h < nh; ++h) {
    cp_wait();
    __syncthreads();  // dst of head h landed; the last head's readers of its pairs are done
    split_tile(dstP, kDS, dst_raw, kDS, kMaxN);
    __syncthreads();  // the pairs are written; the raw tile is free
    if (h + 1 < nh) cp_tile<kMaxN>(dst_raw, kDS, a.dst + (bch0 + h + 1) * P * N, N, P, N);
    cp_commit();
    float r[NJ][4] = {};
    mma3(r, Tile<T, kTS, 1>{Bt}, Pairs<1, kDS>{dstP}, m0, n0, kN);  // R[s][p]
    const float* xh = xt + h * kT * kXS;
    const float* dh = decs + h * kT;
    const float* th = dts + h * kT;
    float u[2] = {0.f, 0.f};  // u[s] / dt[s], before the row sums
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = m0 + g + 8 * (e >> 1), p = n0 + 8 * j + 2 * t + (e & 1);
        r[j][e] *= dh[s];
        u[e >> 1] = fmaf(xh[s * kXS + p], r[j][e], u[e >> 1]);
      }
    put(dxdt, r, h);
    u[0] = sum_row(u[0]) * th[m0 + g];
    u[1] = sum_row(u[1]) * th[m0 + g + 8];
    if (t == 0) {
      rowred[wn * kT + m0 + g] = u[0];
      rowred[wn * kT + m0 + g + 8] = u[1];
    }
    const float d0 = dh[m0 + g] * th[m0 + g], d1 = dh[m0 + g + 8] * th[m0 + g + 8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float xs[NJ][4] = {};
      mma3(xs, XOp<T, kXS, 1>{xh}, Pairs<kDS, 1>{dstP}, m0, 32 * wn + 16 * half,
           kP);  // (x dst)[s][n]
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float* o = sb[NJ * half + j];
        o[0] = fmaf(d0, xs[j][0], o[0]);
        o[1] = fmaf(d0, xs[j][1], o[1]);
        o[2] = fmaf(d1, xs[j][2], o[2]);
        o[3] = fmaf(d1, xs[j][3], o[3]);
      }
    }
    __syncthreads();  // u's partials are complete
    if (tid < kT)
      uacc[h * kT + tid] =
          (rowred[tid] + rowred[kT + tid]) + (rowred[2 * kT + tid] + rowred[3 * kT + tid]);
  }

  // The cluster's sum of the states' term, into SBp.
  cp_wait();
  __syncthreads();  // every reader of the dst tiles is done
  float* sbred = region;  // [64][kDS]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1)
      store2(&sbred[(m0 + g + 8 * e1) * kDS + 32 * wn + 8 * j + 2 * t], sb[j][2 * e1],
             sb[j][2 * e1 + 1]);
  cluster_arrive();
  cluster_wait();
  {
    // Rank q adds the float4s [q per, (q + 1) per) of the 64 x 128 tile.
    float4* out = reinterpret_cast<float4*>(a.SBp + (bcp * nT + st) * kT * kMaxN);
    const int n4 = kT * kMaxN / 4, per = (n4 + CS - 1) / CS, end = min((rank + 1) * per, n4);
    for (int v = rank * per + tid; v < end; v += kHT) {
      const int s = v / (kMaxN / 4), n = 4 * (v % (kMaxN / 4));
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < CS; ++q) {
        const float4 o =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(sbred, q) + s * kDS + n);
        sum.x += o.x;
        sum.y += o.y;
        sum.z += o.z;
        sum.w += o.w;
      }
      out[v] = sum;
    }
  }
  cluster_arrive();

  // Phase 2: the l-tiles at and below the s-tile.
  const int ntri = nT * (nT + 1) / 2;
  cluster_wait();  // the cluster's readers of the region are done
  cp_tile<kMaxN>(Ct, kTS, Cb + s0 * a.csl, a.csl, ns, N);
  load_acs_tile<kHG>(sm + S::acsl + (st & 1) * S::V, a.acs + bch0 * Q, a.acs, Q, nh, st);
  if (nh > 0) cp_tile<kMaxP>(dy_raw, kXS, dyb + s0 * a.ysl, a.ysl, ns, P);
  cp_commit();
  for (int lt = st; lt < nT; ++lt) {
    const int l0 = lt * kT, nl = min(kT, Q - l0);
    const bool diag = lt == st;
    // The warp's 16 x 16 piece lies above the diagonal: G, M, dM and dT are
    // zero there, and M^T dy does not read it.
    const bool above = diag && wn > wm;
    const float* acsl = sm + S::acsl + (lt & 1) * S::V;
    if (lt > st) cluster_wait();  // the last tile's readers of `red` are done
    cp_wait();
    __syncthreads();  // C(lt), a_cs(lt) and dy(lt, first head) landed
    {
      float G[NJ][4] = {};
      if (!above) scores(G, Ct, Bt, N, m0, n0);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int l = m0 + g + 8 * e1, s = n0 + 8 * j + 2 * t;
          store2(&Gt[gidx(l, s)], G[j][2 * e1], G[j][2 * e1 + 1]);
          store2(&red[ridx(l, s)], 0.f, 0.f);
        }
    }
    // Off the diagonal the decay factors through the l-tile's first
    // position, both factors <= 1 (a_cs falls along the chunk):
    // exp(a[l] - a[s]) = e[l] f[s], e[l] = exp(a[l] - a[l0]), f[s] = exp(a[l0] - a[s]).
    if (!diag) {
      for (int i = tid; i < S::V; i += kHT) {
        const int h = i / kT, r = i % kT;
        const float a0 = acsl[h * kT];
        ef[i] = h < nh && r < nl ? expf(acsl[i] - a0) : 0.f;
        ef[S::V + i] = h < nh && r < ns ? expf(a0 - acss[i]) : 0.f;
      }
    }
#pragma unroll 1
    for (int h = 0; h < nh; ++h) {
      if (h > 0) {
        cp_wait();
        __syncthreads();  // dy(lt, h) landed; the last head's readers of the pairs are done
      }
      split_tile(dyP, kPS, dy_raw, kXS, kMaxP);
      __syncthreads();  // dy's pairs are written, the raw tile is free; C's readers are done
      if (h == 0 && lt + 1 < nT) {
        cp_tile<kMaxN>(Ct, kTS, Cb + (l0 + kT) * a.csl, a.csl, min(kT, Q - l0 - kT), N);
        load_acs_tile<kHG>(sm + S::acsl + ((lt + 1) & 1) * S::V, a.acs + bch0 * Q, a.acs, Q,
                           nh, lt + 1);
      }
      if (h + 1 < nh)
        cp_tile<kMaxP>(dy_raw, kXS, dyb + (h + 1) * a.ysh + l0 * a.ysl, a.ysl, nl, P);
      else if (lt + 1 < nT)
        cp_tile<kMaxP>(dy_raw, kXS, dyb + (l0 + kT) * a.ysl, a.ysl, min(kT, Q - l0 - kT), P);
      cp_commit();

      // dM[l][s] = dt[s] sum_p dy[l][p] x[s][p]
      float dm[NJ][4] = {};
      if (!above) mma3(dm, Pairs<kPS, 1>{dyP}, XOp<T, 1, kXS>{xt + h * kT * kXS}, m0, n0, kP);
      const float* ah = acsl + h * kT;
      const float* as = acss + h * kT;
      const float* th = dts + h * kT;
      const float* eh = ef + h * kT;
      const float* fh = ef + S::V + h * kT;
      float row[2] = {0.f, 0.f}, col[NJ][2] = {};
      if (!above) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int l = m0 + g + 8 * e1, s = n0 + 8 * j + 2 * t;
            float mv[2];
            const float2 gv = *reinterpret_cast<const float2*>(&Gt[gidx(l, s)]);
            const float2 tv = *reinterpret_cast<const float2*>(&th[s]);
            float2 dg = *reinterpret_cast<const float2*>(&red[ridx(l, s)]);
#pragma unroll
            for (int e0 = 0; e0 < 2; ++e0) {
              const int e = 2 * e1 + e0;
              dm[j][e] *= e0 ? tv.y : tv.x;
              float lm;
              if (diag) {
                // The exponent's argument is formed only at and below the
                // diagonal, where it is <= 0 (see csrc/ssd_scan.cu).
                const bool in = l < nl && s + e0 < ns && s + e0 <= l;
                lm = in ? expf(ah[l] - as[s + e0]) : 0.f;
              } else {
                lm = eh[l] * fh[s + e0];
              }
              mv[e0] = lm * (e0 ? gv.y : gv.x);
              const float dT = dm[j][e] * mv[e0];
              if (e0)
                dg.y = fmaf(dm[j][e], lm, dg.y);
              else
                dg.x = fmaf(dm[j][e], lm, dg.x);
              row[e1] += dT;
              col[j][e0] += dT;
            }
            *reinterpret_cast<float2*>(&red[ridx(l, s)]) = dg;
            const uint2 p0 = split2(mv[0]), p1 = split2(mv[1]);
            *reinterpret_cast<uint4*>(&MtP[l * kPS + s]) = make_uint4(p0.x, p0.y, p1.x, p1.y);
          }
      }
      row[0] = sum_row(row[0]);
      row[1] = sum_row(row[1]);
      if (t == 0) {
        rowred[wn * kT + m0 + g] = row[0];
        rowred[wn * kT + m0 + g + 8] = row[1];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e0 = 0; e0 < 2; ++e0) {
          const float v = sum_col(col[j][e0]);
          if (g == 0) colred[wm * kT + n0 + 8 * j + 2 * t + e0] = v;
        }
      __syncthreads();  // M and the partial sums are in shared memory

      // dxdt[s][p] += sum_l M[l][s] dy[l][p], from l = s's tile of 16 on
      // (M is zero above the diagonal)
      float acc[NJ][4];
      pick(acc, dxdt, h);
      mma3(acc, Pairs<1, kPS>{MtP}, Pairs<kPS, 1>{dyP}, m0, n0, (nl + 7) & ~7, diag ? m0 : 0);
      put(dxdt, acc, h);
      if (tid < kT) {
        if (tid < nl)
          a.rowp[((bch0 + h) * nT + st) * Q + l0 + tid] =
              (rowred[tid] + rowred[kT + tid]) + (rowred[2 * kT + tid] + rowred[3 * kT + tid]);
        colacc[h * kT + tid] +=
            (colred[tid] + colred[kT + tid]) + (colred[2 * kT + tid] + colred[3 * kT + tid]);
      }
    }

    // The cluster's sum of dG for the tile (lt, st), into dGp.
    cluster_arrive();
    cluster_wait();
    {
      float4* out =
          reinterpret_cast<float4*>(a.dGp + (bcp * ntri + lt * (lt + 1) / 2 + st) * kT * kT);
      const int n4 = kT * kT / 4, per = (n4 + CS - 1) / CS, end = min((rank + 1) * per, n4);
      for (int v = rank * per + tid; v < end; v += kHT) {
        const int l = v / (kT / 4), s = 4 * (v % (kT / 4));
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < CS; ++q) {
          const float4 o =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + l * kMS + s);
          sum.x += o.x;
          sum.y += o.y;
          sum.z += o.z;
          sum.w += o.w;
        }
        out[v] = sum;
      }
    }
    cluster_arrive();
  }
  cluster_wait();  // no rank reads this block's shared memory after it exits
  __syncthreads();

  // dx = dxdt dt, rowsum(dxdt o x) into ddt, colsum(dT) + u, sum of u.
#pragma unroll
  for (int h = 0; h < kHG; ++h) {
    if (h >= nh) break;
    const float* dth = dts + h * kT;
    T* dxh =
        static_cast<T*>(a.dx) + ((static_cast<int64_t>(b) * a.L + row0 + s0) * a.H + h0 + h) * P;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int s = m0 + g + 8 * e1, p = n0 + 8 * j + 2 * t;
        if (s < ns && p < P) {
          const float v0 = dxdt[h][j][2 * e1], v1 = dxdt[h][j][2 * e1 + 1];
          const float2 xv2 = *reinterpret_cast<const float2*>(&xt[(h * kT + s) * kXS + p]);
          rs[e1] = fmaf(v1, xv2.y, fmaf(v0, xv2.x, rs[e1]));
          store2(dxh + static_cast<int64_t>(s) * a.H * P + p, v0 * dth[s], v1 * dth[s]);
        }
      }
    rs[0] = sum_row(rs[0]);
    rs[1] = sum_row(rs[1]);
    if (t == 0) {
      rowred[wn * kT + m0 + g] = rs[0];
      rowred[wn * kT + m0 + g + 8] = rs[1];
    }
    __syncthreads();
    if (tid < ns) {
      a.ddt[(static_cast<int64_t>(b) * a.L + row0 + s0 + tid) * a.H + h0 + h] =
          (rowred[tid] + rowred[kT + tid]) + (rowred[2 * kT + tid] + rowred[3 * kT + tid]);
      a.cpart[(bch0 + h) * Q + s0 + tid] = -colacc[h * kT + tid] - uacc[h * kT + tid];
    }
    if (warp == kHT / 32 - 1) {
      float u = 0.f;
      for (int s = lane; s < ns; s += 32) u += uacc[h * kT + s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) u += __shfl_xor_sync(0xffffffffu, u, off);
      if (lane == 0) a.usum[(bch0 + h) * nT + st] = u;
    }
    __syncthreads();  // rowred is free for the next head
  }
}

// ---------------------------------------------------------------------------
// 2. d a -> ddt and dA per head; dB and dC tiles.
// ---------------------------------------------------------------------------

size_t chunk_smem_bytes(int Q) {
  const size_t tiles = 2 * (static_cast<size_t>(kT) * kMS + static_cast<size_t>(kT) * kWS) * 4;
  const size_t scan = static_cast<size_t>(kThreads / 32) * round4(Q) * 4;
  return tiles > scan ? tiles : scan;
}

// A warp a (b, c, h) chunk: d a_cs summed from the partials, its reverse
// cumulative sum da, ddt += da A, and the chunk's share of dA, sum da dt,
// into dAp (its one writer).  `ci` indexes (b, c, h) chunks.
__device__ __forceinline__ void scan_chunk(const Args& a, float* v, int ci) {
  const int Q = a.Q, nT = a.nT, lane = threadIdx.x & 31;
  const int bc = ci / a.H, h = ci % a.H, b = bc / a.C, c = bc % a.C;
  const int64_t bch = ci, row0 = static_cast<int64_t>(c) * Q;
  float usum = 0.f;
  for (int k = 0; k < nT; ++k) usum += a.usum[bch * nT + k];
  for (int l = lane; l < Q; l += 32) {
    float d = a.dain[bch * Q + l] + a.cpart[bch * Q + l];
    for (int k = 0; k <= l / kT; ++k) d += a.rowp[(bch * nT + k) * Q + l];
    if (l == Q - 1) d += usum;
    v[l] = d;
  }
  __syncwarp();
  // Reverse inclusive scan: a run of positions a lane, a shuffle scan over
  // the runs' totals from the end.
  const int run = (Q + 31) / 32, lo = min(lane * run, Q), hi = min(lo + run, Q);
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
  __syncwarp();
  const float Ah = a.A[h];
  const float* db = a.dt + b * a.dsb + row0 * a.dsl + h * a.dsh;
  float part = 0.f;
  for (int l = lane; l < Q; l += 32) {
    float* o = a.ddt + (static_cast<int64_t>(b) * a.L + row0 + l) * a.H + h;
    *o = fmaf(v[l], Ah, *o);
    part = fmaf(v[l], db[l * a.dsl], part);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) a.dAp[ci] = part;
}

// 3. dA[h] = the sum of the chunks' shares over (b, c), in order.
__global__ void __launch_bounds__(kThreads) bwd_dA(Args a) {
  const int BC = a.B * a.C;
  for (int h = threadIdx.x; h < a.H; h += blockDim.x) {
    float s = 0.f;
    for (int bc = 0; bc < BC; ++bc) s += a.dAp[static_cast<int64_t>(bc) * a.H + h];
    a.dA[h] = s;
  }
}

// A dG tile (lt, st) into D[l][s] (row stride kMS): one part by cp.async
// (dg_copy); several summed in order into registers (dg_gather), the loads
// in flight across the current tile's products, then stored (dg_store).
constexpr int kDgV = kT * kT / 4 / kThreads;  // float4s a thread
__device__ __forceinline__ void dg_copy(float* D, const float* src) {
#pragma unroll
  for (int u = 0; u < kDgV; ++u) {
    const int i = threadIdx.x + u * kThreads, r = i / (kT / 4), c = 4 * (i % (kT / 4));
    cp4(D + r * kMS + c, src + r * kT + c, true);
  }
}
__device__ __forceinline__ void dg_gather(float4 (&v)[kDgV], const float* src, int64_t part_stride,
                                          int NP) {
#pragma unroll
  for (int u = 0; u < kDgV; ++u) v[u] = load4(src + 4 * (threadIdx.x + u * kThreads));
#pragma unroll 4
  for (int q = 1; q < NP; ++q)
#pragma unroll
    for (int u = 0; u < kDgV; ++u) {
      const float4 o = load4(src + q * part_stride + 4 * (threadIdx.x + u * kThreads));
      v[u].x += o.x;
      v[u].y += o.y;
      v[u].z += o.z;
      v[u].w += o.w;
    }
}
__device__ __forceinline__ void dg_store(float* D, const float4 (&v)[kDgV]) {
#pragma unroll
  for (int u = 0; u < kDgV; ++u) {
    const int i = threadIdx.x + u * kThreads, r = i / (kT / 4), c = 4 * (i % (kT / 4));
    *reinterpret_cast<float4*>(D + r * kMS + c) = v[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) bwd_chunk(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = a.Q, N = a.N, BC = a.B * a.C, nT = a.nT;
  const int n_scan = (BC * a.H + kThreads / 32 - 1) / (kThreads / 32);
  int i = blockIdx.x;
  if (i < n_scan) {
    const int warp = threadIdx.x >> 5, ci = i * (kThreads / 32) + warp;
    if (ci < BC * a.H) scan_chunk(a, sm + warp * round4(a.Q), ci);
    return;
  }
  i -= n_scan;
  const bool is_db = i < BC * nT;
  if (!is_db) i -= BC * nT;
  const int tile = is_db ? i / BC : nT - 1 - i / BC;  // heaviest first
  const int bc = i % BC, b = bc / a.C, c = bc % a.C;
  const int64_t row0 = static_cast<int64_t>(c) * Q;
  const int r0 = tile * kT, nr = min(kT, Q - r0);
  const int ntri = nT * (nT + 1) / 2;
  const int64_t part_stride = static_cast<int64_t>(ntri) * kT * kT;
  const float* dg0 = a.dGp + static_cast<int64_t>(bc) * a.NP * part_stride;
  float* Dt[2] = {sm, sm + kT * kMS};
  T* Xt[2] = {reinterpret_cast<T*>(sm + 2 * kT * kMS),
              reinterpret_cast<T*>(sm + 2 * kT * kMS) + kT * kWS};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // dB[s][n] = SB[s][n] + sum_{l >= s} dG[l][s] C[l][n]: the l-tiles tile..nT-1.
  // dC[l][n] = sum_{s <= l} dG[l][s] B[s][n]: the s-tiles 0..tile.
  const T* X = is_db ? static_cast<const T*>(a.Cm) + b * a.csb + row0 * a.csl
                     : static_cast<const T*>(a.Bm) + b * a.bsb + row0 * a.bsl;
  const int64_t xs = is_db ? a.csl : a.bsl;
  const int nk = is_db ? nT - tile : tile + 1;
  // Tile k: the l-tile of a dB block, the s-tile of a dC one.
  auto dg_src = [&](int k) {
    const int other = is_db ? tile + k : k, lt = is_db ? other : tile, st = is_db ? tile : other;
    return dg0 + static_cast<int64_t>(lt * (lt + 1) / 2 + st) * kT * kT;
  };
  auto load_x = [&](int k, int buf) {
    const int other = is_db ? tile + k : k;
    cp_tile<kMaxN>(Xt[buf], kWS, X + other * kT * xs, xs, min(kT, Q - other * kT), N);
  };
  float4 pre[kDgV];
  if (a.NP == 1) {
    dg_copy(Dt[0], dg_src(0));
  } else {
    dg_gather(pre, dg_src(0), part_stride, a.NP);
    dg_store(Dt[0], pre);
  }
  load_x(0, 0);
  cp_commit();
  if (is_db) {
    for (int q = 0; q < a.NP; ++q) {
      const float* sbq = a.SBp + ((static_cast<int64_t>(bc) * a.NP + q) * nT + tile) * kT * kMaxN;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const float2 v = load2(sbq + (m0 + g + 8 * e1) * kMaxN + n0 + 8 * j + 2 * t);
          acc[j][2 * e1] += v.x;
          acc[j][2 * e1 + 1] += v.y;
        }
    }
  }
  for (int k = 0; k < nk; ++k) {
    cp_wait();
    __syncthreads();  // tile k landed; every reader of the other buffers is done
    const bool next = k + 1 < nk;
    if (next) {
      if (a.NP == 1)
        dg_copy(Dt[(k + 1) & 1], dg_src(k + 1));
      else
        dg_gather(pre, dg_src(k + 1), part_stride, a.NP);
      load_x(k + 1, (k + 1) & 1);
      cp_commit();
    }
    if (is_db)
      mma3(acc, Tile<float, 1, kMS>{Dt[k & 1]}, Tile<T, kWS, 1>{Xt[k & 1]}, m0, n0, kT);
    else
      mma3(acc, Tile<float, kMS, 1>{Dt[k & 1]}, Tile<T, kWS, 1>{Xt[k & 1]}, m0, n0, kT);
    if (next && a.NP > 1) dg_store(Dt[(k + 1) & 1], pre);
  }
  T* out = static_cast<T*>(is_db ? a.dB : a.dC) + (static_cast<int64_t>(b) * a.L + row0 + r0) * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int r = m0 + g + 8 * e1, n = n0 + 8 * j + 2 * t;
      if (r < nr && n < N)
        store2(out + static_cast<int64_t>(r) * N + n, acc[j][2 * e1], acc[j][2 * e1 + 1]);
    }
}

constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on the card

// The kernels' shared-memory limits, set once a device (each call costs
// host time that the card waits for).
template <typename T>
cudaError_t set_smem_limits() {
  static int done = -1;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == done) return err;
  if ((err = cudaFuncSetAttribute(bwd_heads<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  HeadsSmem<T>::total * 4)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxSmem)) != cudaSuccess)
    return err;
  done = dev;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int BC = a.B * a.C;
  const size_t s1 = static_cast<size_t>(HeadsSmem<T>::total) * 4;
  const size_t s2 = chunk_smem_bytes(a.Q);
  cudaError_t err = set_smem_limits<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.nT * BC * a.NP * a.CS));
  cfg.blockDim = dim3(kHT);
  cfg.dynamicSmemBytes = s1;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.CS);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, bwd_heads<T>, a)) != cudaSuccess) return err;
  const int n_scan = (BC * a.H + kThreads / 32 - 1) / (kThreads / 32);
  bwd_chunk<T><<<n_scan + 2 * BC * a.nT, kThreads, s2, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dA<<<1, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int64_t ssd_scan_bwd_scratch_floats(int B, int L, int H, int P, int N, int Q,
                                                int dtype) {
  (void)P;
  (void)N;
  if (B <= 0 || L <= 0 || H <= 0 || Q <= 0 || L % Q != 0 || (dtype != 0 && dtype != 1)) return 0;
  return scratch_layout(B, L, H, Q, dtype).total;
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
      P % 4 != 0 || N <= 0 || N > kMaxN || N % 4 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = L / Q, nT = (Q + kT - 1) / kT, NP = n_parts(H, dtype), CS = cluster_size(H, dtype);
  const int64_t BC = static_cast<int64_t>(B) * C;
  if (BC * nT * NP * CS > 0x7fffffff || 2 * BC * nT + BC * H > 0x7fffffff ||
      chunk_smem_bytes(Q) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  // x, B, C and dy are read 4 elements at a time.
  const uintptr_t vec = dtype == 1 ? 8 : 16;
  if (reinterpret_cast<uintptr_t>(x) % vec || reinterpret_cast<uintptr_t>(Bm) % vec ||
      reinterpret_cast<uintptr_t>(Cm) % vec || reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16 || xsb % 4 || xsl % 4 || xsh % 4 || bsb % 4 ||
      bsl % 4 || csb % 4 || csl % 4 || ysb % 4 || ysc % 4 || ysh % 4 || ysl % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_layout(B, L, H, Q, dtype);
  const Args a{x, dt, A, Bm, Cm, acs, dy, dst, dain, dx, ddt, dA, dB, dC,
               scratch + s.dGp, scratch + s.SBp, scratch + s.rowp, scratch + s.cpart,
               scratch + s.usum, scratch + s.dAp,
               B, L, H, P, N, Q, C, nT, NP, CS,
               xsb, xsl, xsh, dsb, dsl, dsh, bsb, bsl, csb, csl, ysb, ysc, ysh, ysl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(a, st) : launch<__nv_bfloat16>(a, st);
  return static_cast<int>(err);
}
