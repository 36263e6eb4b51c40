// adamw_step: one AdamW update over a step's leaves, out of place, written
// by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's AdamW is jnp code
// (src/repro/optim/optimizers.py:42-60) that XLA fuses on the TPU.  It was
// added because the port's plain update, about 23 elementwise launches per
// 2^24-element slice, moved about 200 bytes an element a step.  It computes
// the reference's rule, with every step in fp32 whatever the stored dtypes:
//
//     m' = b1 * m + (1 - b1) * g
//     v' = b2 * v + (1 - b2) * g * g
//     p' = p - lr * ((m' / c1) / (sqrt(v' / c2) + eps) + wd * p)
//
// operation for operation as the plain PyTorch loop computes it on the card
// (kernels/adamw.py adamw_step_plain), so the two agree bit for bit:
//   * each product, sum, quotient and root rounds once, with
//     __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn, so that nvcc
//     contracts nothing into an FMA;
//   * the scalars come from the host as PyTorch makes them for a
//     tensor-scalar op: the Python float rounded to fp32 (1 - b1 is formed
//     in double first), and a division by a Python scalar is a product with
//     its fp32 reciprocal, 1.0f / float(c), which is what PyTorch's CUDA
//     true division does when the divisor is a CPU scalar;
//   * the stored dtypes widen exactly, and the results narrow to nearest
//     even, as .float() and .to() do.
//
// What bounds it: HBM bytes.  Each element is read once from p, g, m, v and
// written once to fresh p, m, v: 22 B for bf16 weights and gradients with
// fp32 moments, 28 B all fp32, for about 14 flops and one division and one
// root: under 1 flop a byte, far below the ~20 flop/byte where the H100's
// fp32 rate would take over.  At 3.35 TB/s olmo-1b's 1.18 B parameters take
// at least 7.7 ms a step and FEMNIST's 164 M fp32 ones 1.37 ms.  What the
// design does about it:
//   * One launch takes a table of up to kMaxLeaves leaves of one
//     (param dtype, state dtype) pair, passed by value as the kernel's
//     parameter (__grid_constant__, so the block reads it in place from the
//     constant bank): no host synchronisation and no copy of the table.
//   * Each block takes one chunk of kChunk elements of one leaf.  It finds
//     its leaf by a binary search over the leaves' first blocks, the same
//     for all its threads.  Small leaves (biases, norms, adapters) share the
//     launch with the large ones.
//   * A leaf whose seven pointers are aligned to 4 elements is read and
//     written 4 elements a thread at a time, two such quads in flight:
//     16-byte loads of fp32, 8-byte loads of the 2-byte dtypes, each warp
//     instruction over one contiguous span of every stream (a thread taking
//     8 contiguous fp32 elements as two 16-byte halves would leave every
//     instruction half its sectors, and ran at 28 % of the bound), with
//     the streaming hints (ld.cs, st.cs); its ragged end goes element by
//     element.
//     A leaf that is a view at another offset (a leaf of a flat buffer
//     unflattened) goes element by element, coalesced.  A scalar head
//     cannot align it instead: the outputs are fresh allocations, so no
//     head aligns both them and the view.
//   * All offsets are 64-bit.
//
// Interface: plain C, loaded with ctypes.  Launches on the given stream and
// does not synchronize.  Returns cudaGetLastError() after the last launch
// (0 = launched), or cudaErrorInvalidValue for arguments it does not take,
// and writes the number of launches it made.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQuad = 4;    // contiguous elements a thread loads from each stream at once
constexpr int kQuads = 2;   // quads a thread has in flight, kThreads * kQuad elements apart
constexpr int kIters = 4;   // rounds of kQuads quads a thread takes in a chunk
constexpr int64_t kSpan = static_cast<int64_t>(kThreads) * kQuad;  // a quad's block-wide span
constexpr int64_t kChunk = kSpan * kQuads * kIters;                 // 8192 elements a block
constexpr int kMaxLeaves = 48;  // the table stays under the 4 KB parameter limit
constexpr int kPointers = 7;    // p, g, m, v, p', m', v'

struct Leaf {
  const void* p;
  const void* g;
  const void* m;
  const void* v;
  void* p_out;
  void* m_out;
  void* v_out;
  int64_t n;
  int first_block;  // the leaf's first block in this launch
  int vec;          // every pointer aligned to kQuad elements
};

struct Rule {
  float b1, one_minus_b1, b2, one_minus_b2, inv_c1, inv_c2, eps, wd, lr;

  __device__ __forceinline__ void operator()(float& p, float g, float& m, float& v) const {
    m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(one_minus_b1, g));
    v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(one_minus_b2, g), g));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, inv_c2)), eps);
    const float delta = __fadd_rn(__fdiv_rn(__fmul_rn(m, inv_c1), den), __fmul_rn(wd, p));
    p = __fsub_rn(p, __fmul_rn(lr, delta));
  }
};

struct Table {
  Rule rule;
  int n_leaves;
  Leaf leaf[kMaxLeaves];
};
static_assert(sizeof(Table) <= 4096, "the leaf table must fit the kernel parameter space");

union Pack8 {
  uint2 u;
  unsigned short h[kQuad];
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ __forceinline__ static float get(const void* base, int64_t i) {
    return __ldcs(static_cast<const float*>(base) + i);
  }
  __device__ __forceinline__ static void put(void* base, int64_t i, float x) {
    __stcs(static_cast<float*>(base) + i, x);
  }
  __device__ __forceinline__ static void get4(const void* base, int64_t i, float (&x)[kQuad]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(static_cast<const float*>(base) + i));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ __forceinline__ static void put4(void* base, int64_t i, const float (&x)[kQuad]) {
    __stcs(reinterpret_cast<float4*>(static_cast<float*>(base) + i),
           make_float4(x[0], x[1], x[2], x[3]));
  }
};

// The 2-byte dtypes travel as their raw 16-bit patterns.
template <typename Half>
struct Io16 {
  __device__ __forceinline__ static float get(const void* base, int64_t i) {
    return Half::widen(__ldcs(static_cast<const unsigned short*>(base) + i));
  }
  __device__ __forceinline__ static void put(void* base, int64_t i, float x) {
    __stcs(static_cast<unsigned short*>(base) + i, Half::narrow(x));
  }
  __device__ __forceinline__ static void get4(const void* base, int64_t i, float (&x)[kQuad]) {
    Pack8 v;
    v.u = __ldcs(reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(base) + i));
#pragma unroll
    for (int k = 0; k < kQuad; ++k) x[k] = Half::widen(v.h[k]);
  }
  __device__ __forceinline__ static void put4(void* base, int64_t i, const float (&x)[kQuad]) {
    Pack8 v;
#pragma unroll
    for (int k = 0; k < kQuad; ++k) v.h[k] = Half::narrow(x[k]);
    __stcs(reinterpret_cast<uint2*>(static_cast<unsigned short*>(base) + i), v.u);
  }
};

struct Bf16 {
  __device__ __forceinline__ static float widen(unsigned short b) {
    return __uint_as_float(static_cast<unsigned int>(b) << 16);
  }
  __device__ __forceinline__ static unsigned short narrow(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

struct Fp16 {
  __device__ __forceinline__ static float widen(unsigned short h) {
    return __half2float(__ushort_as_half(h));
  }
  __device__ __forceinline__ static unsigned short narrow(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

template <>
struct Io<__nv_bfloat16> : Io16<Bf16> {};
template <>
struct Io<__half> : Io16<Fp16> {};

template <typename P, typename S>
__device__ __forceinline__ void update_one(const Leaf& l, const Rule& r, int64_t i) {
  float p = Io<P>::get(l.p, i), m = Io<S>::get(l.m, i), v = Io<S>::get(l.v, i);
  r(p, Io<P>::get(l.g, i), m, v);
  Io<P>::put(l.p_out, i, p);
  Io<S>::put(l.m_out, i, m);
  Io<S>::put(l.v_out, i, v);
}

template <typename P, typename S>
__global__ void __launch_bounds__(kThreads) adamw_kernel(const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first_block <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& l = t.leaf[lo];
  const Rule r = t.rule;
  const int64_t base = static_cast<int64_t>(b - l.first_block) * kChunk;
  const int64_t end = base + kChunk < l.n ? base + kChunk : l.n;
  if (l.vec) {
#pragma unroll 1
    for (int it = 0; it < kIters; ++it) {
      const int64_t i0 = base + it * kSpan * kQuads + threadIdx.x * kQuad;
      if (i0 + (kQuads - 1) * kSpan + kQuad <= end) {
        float p[kQuads][kQuad], g[kQuads][kQuad], m[kQuads][kQuad], v[kQuads][kQuad];
#pragma unroll
        for (int h = 0; h < kQuads; ++h) {
          Io<P>::get4(l.p, i0 + h * kSpan, p[h]);
          Io<P>::get4(l.g, i0 + h * kSpan, g[h]);
          Io<S>::get4(l.m, i0 + h * kSpan, m[h]);
          Io<S>::get4(l.v, i0 + h * kSpan, v[h]);
        }
#pragma unroll
        for (int h = 0; h < kQuads; ++h) {
#pragma unroll
          for (int k = 0; k < kQuad; ++k) r(p[h][k], g[h][k], m[h][k], v[h][k]);
          Io<P>::put4(l.p_out, i0 + h * kSpan, p[h]);
          Io<S>::put4(l.m_out, i0 + h * kSpan, m[h]);
          Io<S>::put4(l.v_out, i0 + h * kSpan, v[h]);
        }
      } else {
        for (int h = 0; h < kQuads; ++h) {
          const int64_t i = i0 + h * kSpan;
          for (int64_t j = i; j < i + kQuad && j < end; ++j) update_one<P, S>(l, r, j);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kQuad * kQuads * kIters; ++it) {
      const int64_t i = base + static_cast<int64_t>(it) * kThreads + threadIdx.x;
      if (i < end) update_one<P, S>(l, r, i);
    }
  }
}

template <typename T>
bool quad_aligned(uint64_t ptr) { return ptr % (kQuad * sizeof(T)) == 0; }

template <typename P, typename S>
cudaError_t launch_all(int n_leaves, const uint64_t* ptrs, const int64_t* numel, const Rule& rule,
                       cudaStream_t stream, int* launches) {
  Table t;
  t.rule = rule;
  t.n_leaves = 0;
  int64_t blocks = 0;
  auto flush = [&]() -> cudaError_t {
    if (t.n_leaves == 0) return cudaSuccess;
    adamw_kernel<P, S><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(t);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*launches;
    t.n_leaves = 0;
    blocks = 0;
    return err;
  };
  for (int k = 0; k < n_leaves; ++k) {
    const int64_t n = numel[k];
    if (n == 0) continue;
    const int64_t need = (n + kChunk - 1) / kChunk;
    if (t.n_leaves == kMaxLeaves || blocks + need > 0x7fffffff) {
      const cudaError_t err = flush();
      if (err != cudaSuccess) return err;
    }
    if (need > 0x7fffffff) return cudaErrorInvalidValue;
    const uint64_t* q = ptrs + static_cast<int64_t>(k) * kPointers;
    Leaf& l = t.leaf[t.n_leaves++];
    l.p = reinterpret_cast<const void*>(q[0]);
    l.g = reinterpret_cast<const void*>(q[1]);
    l.m = reinterpret_cast<const void*>(q[2]);
    l.v = reinterpret_cast<const void*>(q[3]);
    l.p_out = reinterpret_cast<void*>(q[4]);
    l.m_out = reinterpret_cast<void*>(q[5]);
    l.v_out = reinterpret_cast<void*>(q[6]);
    l.n = n;
    l.first_block = static_cast<int>(blocks);
    l.vec = quad_aligned<P>(q[0]) && quad_aligned<P>(q[1]) && quad_aligned<S>(q[2]) &&
            quad_aligned<S>(q[3]) && quad_aligned<P>(q[4]) && quad_aligned<S>(q[5]) &&
            quad_aligned<S>(q[6]);
    blocks += need;
  }
  return flush();
}

template <typename P>
cudaError_t by_state(int s_dtype, int n_leaves, const uint64_t* ptrs, const int64_t* numel,
                     const Rule& rule, cudaStream_t stream, int* launches) {
  switch (s_dtype) {
    case 0: return launch_all<P, float>(n_leaves, ptrs, numel, rule, stream, launches);
    case 1: return launch_all<P, __nv_bfloat16>(n_leaves, ptrs, numel, rule, stream, launches);
    case 2: return launch_all<P, __half>(n_leaves, ptrs, numel, rule, stream, launches);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.  ptrs holds n_leaves
// rows of 7 device pointers (p, g, m, v, p', m', v'); numel each leaf's
// element count (0: skipped); scalars the nine fp32 numbers b1, 1 - b1, b2,
// 1 - b2, 1/c1, 1/c2, eps, weight decay, lr.  *launches gets the number of
// kernels launched (one per kMaxLeaves leaves).
extern "C" int adamw_step_launch(int n_leaves, const uint64_t* ptrs, const int64_t* numel,
                                 int p_dtype, int s_dtype, const float* scalars, void* stream,
                                 int* launches) {
  if (n_leaves < 0 || ptrs == nullptr || numel == nullptr || scalars == nullptr ||
      launches == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  *launches = 0;
  for (int k = 0; k < n_leaves; ++k) {
    if (numel[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < kPointers && numel[k] > 0; ++j)
      if (ptrs[static_cast<int64_t>(k) * kPointers + j] == 0)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rule rule = {scalars[0], scalars[1], scalars[2], scalars[3], scalars[4],
                     scalars[5], scalars[6], scalars[7], scalars[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p_dtype) {
    case 0: err = by_state<float>(s_dtype, n_leaves, ptrs, numel, rule, s, launches); break;
    case 1: err = by_state<__nv_bfloat16>(s_dtype, n_leaves, ptrs, numel, rule, s, launches); break;
    case 2: err = by_state<__half>(s_dtype, n_leaves, ptrs, numel, rule, s, launches); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
