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
// the decay is not zero (s <= l), is about 6.72 GFLOP (y Q*(Q+1)*P and st
// 2*P*N*Q per (b, c, h), the scores Q*(Q+1)*N once per (b, c)), 0.100 ms
// at 67 TFLOP/s of fp32, against about 106 MB moved, 0.032 ms: operations.  This first version recomputes the scores C . B^T
// for every head (the TPU kernel shares them across a block of 8 heads),
// and works in fp32 on the CUDA cores; tensor cores and sharing the
// scores are later work.  What the design does within that:
//   * One block of 256 threads per (b, c, h): 768 blocks at mamba2-130m's
//     prefill, six waves of two blocks an SM.
//   * a_cs is one warp's scan in shared memory: each lane sums a run of
//     positions, a shuffle scan adds the runs.
//   * y is formed in 64 x 64 tiles (l, s <= l), like attention without the
//     softmax: the scores, the decay and dt are combined in registers into a
//     64 x 64 weight tile in shared memory, then multiplied into the 64 x P
//     output tile held in registers.  Tiles above the diagonal are skipped.
//   * Each thread owns 4 x 4 of a score tile, 4 x 4 of the output tile and
//     4 x 8 of the state, and reads shared memory as float4 (rows padded by
//     4 floats), so the loops are bound by FMAs, not shared-memory reads.
//   * A ragged chunk (Q not a multiple of 64) is masked here.
//
// Limits, checked on the host: P <= 64, N <= 128, both multiples of 4.
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
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kNS = kMaxN + 4;   // row stride of the B and C tiles (floats)
constexpr int kXS = kMaxP + 4;   // row stride of the x tile
constexpr int kWS = kT + 4;      // row stride of the weight tile

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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

size_t smem_bytes(int Q) {
  return (2 * static_cast<size_t>(Q) + 2 * kT * kNS + kT * kXS + kT * kWS) * 4;
}

// Rows [s0, s0 + 64) of an (L, width) slab starting at `base` (row stride
// `ls`) into a tile of row stride `ts`, zero past the chunk's Q rows.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, int ts, const T* base, int64_t ls,
                                          int s0, int Q, int width) {
  for (int i = threadIdx.x; i < kT * width; i += kThreads) {
    const int r = i / width, col = i % width, s = s0 + r;
    tile[r * ts + col] = s < Q ? load_f(base + s * ls + col) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_intra(Args a) {
  extern __shared__ float4 smem4[];
  float* acs = reinterpret_cast<float*>(smem4);
  float* dts = acs + a.Q;
  float* Cs = dts + a.Q;
  float* Bs = Cs + kT * kNS;
  float* Xs = Bs + kT * kNS;
  float* Ws = Xs + kT * kXS;
  // 2 * Q floats ahead of the tiles: Q is even or the tiles lose 16-byte
  // alignment, so the host only takes Q % 2 == 0.

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x % a.H;
  const int bc = blockIdx.x / a.H;
  const int c = bc % a.C, b = bc / a.C;
  const int Q = a.Q, P = a.P, N = a.N;
  const int64_t row0 = static_cast<int64_t>(c) * Q;  // first position of the chunk

  const T* xb = static_cast<const T*>(a.x) + b * a.xsb + row0 * a.xsl + h * a.xsh;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bsb + row0 * a.bsl;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.csb + row0 * a.csl;
  const float* db = a.dt + b * a.dsb + row0 * a.dsl + h * a.dsh;
  const int64_t out_bch = (static_cast<int64_t>(b) * a.C + c) * a.H + h;

  // --- a_cs = cumsum(dt * A): warp 0, a run of positions per lane --------
  for (int i = tid; i < Q; i += kThreads) dts[i] = db[i * a.dsl];
  __syncthreads();
  if (tid < 32) {
    const float Ah = a.A[h];
    const int run = (Q + 31) / 32;
    const int lo = min(tid * run, Q), hi = min(lo + run, Q);
    float sum = 0.f;
    for (int i = lo; i < hi; ++i) {
      sum += dts[i] * Ah;
      acs[i] = sum;
    }
    float incl = sum;  // inclusive scan of the runs' totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += o;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);  // the runs before this lane's
    if (tid == 0) before = 0.f;
    for (int i = lo; i < hi; ++i) acs[i] += before;
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads) a.acs[out_bch * Q + i] = acs[i];

  const int n_tiles = (Q + kT - 1) / kT;

  // --- chunk state: st[p, n] = sum_s (x dt decay)[s, p] B[s, n] -----------
  {
    const float a_last = acs[Q - 1];
    float sacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const int s0 = t * kT;
      __syncthreads();
      load_tile(Bs, kNS, Bb, a.bsl, s0, Q, N);
      load_tile(Xs, kXS, xb, a.xsl, s0, Q, P);
      __syncthreads();
      for (int i = tid; i < kT * P; i += kThreads) {  // weighted x into Ws
        const int r = i / P, p = i % P, s = s0 + r;
        Ws[r * kWS + p] = s < Q ? Xs[r * kXS + p] * dts[s] * expf(a_last - acs[s]) : 0.f;
      }
      __syncthreads();
      if (4 * ty < P) {
        for (int r = 0; r < kT; ++r) {
          const float4 wf = *reinterpret_cast<const float4*>(&Ws[r * kWS + 4 * ty]);
          const float w[4] = {wf.x, wf.y, wf.z, wf.w};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (4 * tx + 64 * j >= N) continue;
            const float4 bf = *reinterpret_cast<const float4*>(&Bs[r * kNS + 4 * tx + 64 * j]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              sacc[i][4 * j + 0] = fmaf(w[i], bf.x, sacc[i][4 * j + 0]);
              sacc[i][4 * j + 1] = fmaf(w[i], bf.y, sacc[i][4 * j + 1]);
              sacc[i][4 * j + 2] = fmaf(w[i], bf.z, sacc[i][4 * j + 2]);
              sacc[i][4 * j + 3] = fmaf(w[i], bf.w, sacc[i][4 * j + 3]);
            }
          }
        }
      }
    }
    float* stb = a.st + out_bch * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 4 * ty + i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 4 * tx + 64 * (j / 4) + (j % 4);
        if (n < N) stb[p * N + n] = sacc[i][j];
      }
    }
  }

  // --- y: 64 x 64 tiles (l, s <= l) ---------------------------------------
  for (int lt = 0; lt < n_tiles; ++lt) {
    const int l0 = lt * kT;
    float yacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
    __syncthreads();
    load_tile(Cs, kNS, Cb, a.csl, l0, Q, N);
    for (int st = 0; st <= lt; ++st) {
      const int s0 = st * kT;
      if (st > 0) __syncthreads();  // the last tile's readers of Bs, Xs, Ws are done
      load_tile(Bs, kNS, Bb, a.bsl, s0, Q, N);
      load_tile(Xs, kXS, xb, a.xsl, s0, Q, P);
      __syncthreads();

      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cf[4], bf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cf[i] = *reinterpret_cast<const float4*>(&Cs[(4 * ty + i) * kNS + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * kNS + n]);
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
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + tx + 16 * j;
          float w = 0.f;
          if (s <= l && l < Q) w = sc[i][j] * expf(acs[l] - acs[s]) * dts[s];
          Ws[(4 * ty + i) * kWS + tx + 16 * j] = w;
        }
      }
      __syncthreads();

      if (4 * tx < P) {
#pragma unroll 2
        for (int r = 0; r < kT; r += 4) {
          float4 wf[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wf[i] = *reinterpret_cast<const float4*>(&Ws[(4 * ty + i) * kWS + r]);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float4 xf = *reinterpret_cast<const float4*>(&Xs[(r + rr) * kXS + 4 * tx]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float w = rr == 0 ? wf[i].x : rr == 1 ? wf[i].y : rr == 2 ? wf[i].z : wf[i].w;
              yacc[i][0] = fmaf(w, xf.x, yacc[i][0]);
              yacc[i][1] = fmaf(w, xf.y, yacc[i][1]);
              yacc[i][2] = fmaf(w, xf.z, yacc[i][2]);
              yacc[i][3] = fmaf(w, xf.w, yacc[i][3]);
            }
          }
        }
      }
    }
    if (4 * tx < P) {
      float* yb = a.y + out_bch * Q * P;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + 4 * ty + i;
        if (l >= Q) continue;
        *reinterpret_cast<float4*>(&yb[static_cast<int64_t>(l) * P + 4 * tx]) =
            make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_intra<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_intra<T><<<a.B * a.C * a.H, kThreads, smem, stream>>>(a);
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
      static_cast<int64_t>(B) * (L / Q) * H > 0x7fffffff || smem_bytes(Q) > 232448) {
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
