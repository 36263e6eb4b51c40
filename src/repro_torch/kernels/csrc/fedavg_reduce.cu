// fedavg_reduce: the weighted FedAvg reduce over stacked client parameters,
// written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/fedavg_reduce.py::_fedavg_kernel, the Pallas TPU
// kernel.  It computes the same function:
//
//     out[l] = sum_n w[n] * x[n, l]        (w already normalized to sum 1)
//
// with the sum kept in fp32 and the result written in x's dtype (fp32 or
// bf16).  x is an (N, L) buffer whose rows may sit row_stride elements
// apart (row_stride >= L); the columns of a row are contiguous.
//
// What bounds it: HBM bytes.  Each call must read N*L inputs and write L
// outputs, (N+1)*L*itemsize bytes, and does 2*N*L flops: at most 0.5 flop a
// byte for fp32, far below the ~20 flop/byte where the H100's fp32 rate
// would take over.  So the only goal is to stream those bytes once at the
// card's memory rate.  What the design does about it:
//   * Each thread owns one 16-byte vector of columns (4 fp32 or 8 bf16)
//     and walks the N rows, keeping the fp32 sums in registers: every
//     input byte is read once, every output byte written once, and no
//     (N, L) temporary or padded copy is ever made.
//   * Loads are 16 bytes a thread with neighbouring threads on
//     neighbouring addresses, and use the streaming cache hint (ld.cs):
//     the data are read exactly once, so they should not evict anything.
//   * The row loop is unrolled by 4 so each thread has several loads in
//     flight.  The grid is exactly one wave, as many blocks as the SMs
//     hold at once (from the occupancy API), and a grid-stride loop
//     covers any L: a grid of more blocks than fit would run its last
//     blocks' whole shares in a second, mostly idle wave.
//   * All offsets are 64-bit: N*L passes 2^31 at paper width (L =
//     164,187,070) from N = 14 on.
//   * The ragged tail (L % vec columns) is masked inside the kernel.
//
// The 16-byte loads need every row to start on 16 bytes.  The port's
// RavelPlan.flatten_stack lays rows out with a row stride padded to a
// multiple of BLOCK = 8192 elements, so the main path always takes the
// vector kernel.  A buffer whose rows are not 16-byte aligned (a
// contiguous (N, L) tensor with L % 4 != 0, as at paper width) goes to a
// scalar kernel over the same arithmetic: 4- or 2-byte loads, still
// coalesced, still one read of each byte.
//
// Making it faster (TMA bulk loads, persistent blocks) is later work.
//
// Interface: plain C, loaded with ctypes.  Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for arguments
// it does not take.  Launches on the given stream and does not synchronize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

union Pack16 {
  uint4 u;
  float f[4];
  unsigned short h[8];
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static float load(const float* p) { return __ldcs(p); }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
  __device__ __forceinline__ static float lane(const Pack16& v, int k) { return v.f[k]; }
  __device__ __forceinline__ static void set(Pack16& v, int k, float x) { v.f[k] = x; }
};

// bf16 travels as its raw 16-bit pattern: widening is a shift, narrowing
// rounds to nearest even (as torch's and JAX's casts do).
template <>
struct Elem<unsigned short> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float widen(unsigned short b) {
    return __uint_as_float(static_cast<unsigned int>(b) << 16);
  }
  __device__ __forceinline__ static unsigned short narrow(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static float load(const unsigned short* p) { return widen(__ldcs(p)); }
  __device__ __forceinline__ static void store(unsigned short* p, float v) { *p = narrow(v); }
  __device__ __forceinline__ static float lane(const Pack16& v, int k) { return widen(v.h[k]); }
  __device__ __forceinline__ static void set(Pack16& v, int k, float x) { v.h[k] = narrow(x); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_vec_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                  int n, int64_t L, int64_t row_stride) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  const int64_t n_vec = L / V;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = tid; v < n_vec; v += step) {
    const T* col = x + v * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      Pack16 p;
      p.u = __ldcs(reinterpret_cast<const uint4*>(col + static_cast<int64_t>(r) * row_stride));
      const float wr = __ldg(w + r);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(wr, E::lane(p, k), acc[k]);
    }
    Pack16 o;
#pragma unroll
    for (int k = 0; k < V; ++k) E::set(o, k, acc[k]);
    *reinterpret_cast<uint4*>(out + v * V) = o.u;
  }
  // Ragged tail: the last L % V columns, one thread each.
  const int64_t c = n_vec * V + tid;
  if (c < L) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r)
      acc = fmaf(__ldg(w + r), E::load(x + static_cast<int64_t>(r) * row_stride + c), acc);
    E::store(out + c, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                     int n, int64_t L, int64_t row_stride) {
  using E = Elem<T>;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = tid; c < L; c += step) {
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < n; ++r)
      acc = fmaf(__ldg(w + r), E::load(x + static_cast<int64_t>(r) * row_stride + c), acc);
    E::store(out + c, acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int n, int64_t L,
                   int64_t row_stride, cudaStream_t stream) {
  constexpr int V = Elem<T>::kVec;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && row_stride % V == 0;
  err = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fedavg_vec_kernel<T>, kThreads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fedavg_scalar_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t work = vec ? (L / V > 0 ? L / V : 1) : L;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  const T* xs = static_cast<const T*>(x);
  const float* ws = static_cast<const float*>(w);
  T* os = static_cast<T*>(out);
  if (vec)
    fedavg_vec_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xs, ws, os, n, L, row_stride);
  else
    fedavg_scalar_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xs, ws, os, n, L, row_stride);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int fedavg_reduce_launch(const void* x, const void* w, void* out, int64_t n,
                                    int64_t L, int64_t row_stride, int dtype, void* stream) {
  if (n < 1 || n > 0x7fffffff || L < 1 || row_stride < L || x == nullptr || w == nullptr ||
      out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, out, static_cast<int>(n), L, row_stride, s));
    case 1:
      return static_cast<int>(launch<unsigned short>(x, w, out, static_cast<int>(n), L, row_stride, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
