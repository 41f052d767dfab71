// Helpers shared by the package's CUDA kernels: fp32 <-> storage-type
// conversion, rounding to the compute type, warp reductions, and the error
// string export that the Python bindings use to report a failed launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msst {

constexpr float kLnEps = 1e-5f;  // torch nn.LayerNorm default, fp32 statistics

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to the compute type C and widened back: the cast the TPU kernels
// apply to every matmul operand before an fp32-accumulated product
template <typename C> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<C>(v));
}

// v rounded to C and stored as O (O is fp32, or C itself)
template <typename C, typename O> __device__ __forceinline__ O rounded(float v) {
  return from_f<O>(round_to<C>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace msst

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
