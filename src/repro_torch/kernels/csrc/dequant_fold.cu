// dequant_fold: fold one quantized client update into the server's fp32
// accumulator, in place, written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/fedavg_reduce.py::_dequant_fold_kernel, the Pallas
// TPU kernel.  It computes the same function:
//
//     acc[i] += (w * scales[i / 8192]) * float(data[i])     for i < n
//
// where data is the wire payload of one int8 update (per-8192-element
// scales) or one fp16 update (unit scales), acc is the fp32 accumulator of
// the round, and w is the update's fold weight.  Each product and the sum
// are rounded in fp32 in that order (ws = w*s, p = ws*x, acc + p), with
// __fmul_rn/__fadd_rn so that nvcc cannot contract them into an FMA: the
// kernel then equals the plain PyTorch version bit for bit.
//
// What bounds it: HBM bytes.  Each element costs a 4-byte accumulator read,
// a 4-byte accumulator write and 1 (int8) or 2 (fp16) payload bytes, for 2
// flops: about 0.2 flop a byte, far below the ~20 flop/byte where the
// H100's fp32 rate would take over.  So the only goal is to stream those
// bytes once at the card's memory rate.  What the design does about it:
//   * Each thread owns 16 bytes of payload (16 int8 codes or 8 fp16
//     values): one 16-byte load of data, and 16-byte loads and stores of
//     the matching 4 or 2 fp32 accumulator vectors.  8192 is a multiple of
//     16, so a thread's vector never straddles a scale block; its scale is
//     one cached load of scales[i / 8192].
//   * The payload is read exactly once, with the streaming cache hint
//     (ld.cs), and nothing else is allocated: no dense fp32 copy of the
//     update and no padded copy of the payload.
//   * The payload is n = total_elems long, not padded to the accumulator's
//     length.  The kernel masks the ragged tail itself, and the
//     accumulator's elements past n are never touched, which is what the
//     reference's zero padding adds to them.
//   * The grid is exactly one wave (blocks per SM from the occupancy API
//     times the SM count), with a grid-stride loop over any n, and every
//     offset is 64-bit.
//
// A payload or accumulator pointer that is not 16-byte aligned (a slice of
// a payload buffer) goes to a scalar kernel over the same arithmetic, never
// to the plain version.
//
// Making it faster (TMA bulk loads, persistent blocks) is later work.
//
// Interface: plain C, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for arguments it does
// not take.  Launches on the given stream and does not synchronize.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kBlock = 8192;  // elements per scale block (wire constant)

union Pack16 {
  uint4 u;
  signed char c[16];
  unsigned short h[8];
};

template <typename T>
struct Code;

template <>
struct Code<signed char> {
  static constexpr int kVec = 16;
  __device__ __forceinline__ static float lane(const Pack16& v, int k) {
    return static_cast<float>(v.c[k]);
  }
  __device__ __forceinline__ static float load(const signed char* p) {
    return static_cast<float>(__ldcs(p));
  }
};

template <>
struct Code<unsigned short> {  // fp16 as its raw 16-bit pattern
  static constexpr int kVec = 8;
  __device__ __forceinline__ static float lane(const Pack16& v, int k) {
    return __half2float(__ushort_as_half(v.h[k]));
  }
  __device__ __forceinline__ static float load(const unsigned short* p) {
    return __half2float(__ushort_as_half(__ldcs(p)));
  }
};

__device__ __forceinline__ float fold_one(float a, float ws, float x) {
  return __fadd_rn(a, __fmul_rn(ws, x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_fold_vec_kernel(float* __restrict__ acc, const T* __restrict__ data,
                        const float* __restrict__ scales, float w, int64_t n) {
  using C = Code<T>;
  constexpr int V = C::kVec;
  const int64_t n_vec = n / V;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = tid; v < n_vec; v += step) {
    const int64_t i0 = v * V;
    Pack16 p;
    p.u = __ldcs(reinterpret_cast<const uint4*>(data + i0));
    const float ws = __fmul_rn(w, __ldg(scales + i0 / kBlock));
    float4* a4 = reinterpret_cast<float4*>(acc + i0);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      float4 a = a4[q];
      a.x = fold_one(a.x, ws, C::lane(p, 4 * q + 0));
      a.y = fold_one(a.y, ws, C::lane(p, 4 * q + 1));
      a.z = fold_one(a.z, ws, C::lane(p, 4 * q + 2));
      a.w = fold_one(a.w, ws, C::lane(p, 4 * q + 3));
      a4[q] = a;
    }
  }
  // Ragged tail: the last n % V elements, one thread each.
  const int64_t i = n_vec * V + tid;
  if (i < n) {
    const float ws = __fmul_rn(w, __ldg(scales + i / kBlock));
    acc[i] = fold_one(acc[i], ws, C::load(data + i));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_fold_scalar_kernel(float* __restrict__ acc, const T* __restrict__ data,
                           const float* __restrict__ scales, float w, int64_t n) {
  using C = Code<T>;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = tid; i < n; i += step) {
    const float ws = __fmul_rn(w, __ldg(scales + i / kBlock));
    acc[i] = fold_one(acc[i], ws, C::load(data + i));
  }
}

template <typename T>
cudaError_t launch(void* acc, const void* data, const void* scales, float w, int64_t n,
                   cudaStream_t stream) {
  constexpr int V = Code<T>::kVec;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0;
  err = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dequant_fold_vec_kernel<T>,
                                                            kThreads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, dequant_fold_scalar_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  // The vector kernel's tail needs n % V < blocks * kThreads threads: at
  // least one block always covers V - 1 < kThreads.
  const int64_t work = vec ? (n / V > 0 ? n / V : 1) : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  float* a = static_cast<float*>(acc);
  const T* d = static_cast<const T*>(data);
  const float* s = static_cast<const float*>(scales);
  if (vec)
    dequant_fold_vec_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, d, s, w, n);
  else
    dequant_fold_scalar_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, d, s, w, n);
  return cudaGetLastError();
}

}  // namespace

// code: 0 = int8, 1 = float16.  n is the payload length; the accumulator
// and the scales must cover it (len(acc) >= n, len(scales) >= ceil(n/8192)).
extern "C" int dequant_fold_launch(void* acc, const void* data, const void* scales, float w,
                                   int64_t n, int code, void* stream) {
  if (n < 1 || acc == nullptr || data == nullptr || scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0:
      return static_cast<int>(launch<signed char>(acc, data, scales, w, n, s));
    case 1:
      return static_cast<int>(launch<unsigned short>(acc, data, scales, w, n, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
