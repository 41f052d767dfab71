// Warp-level tensor-core helpers shared by the register-resident kernels
// (fused_layer_fwd.cu, the row kernel of fused_layer_bwd.cu,
// fused_embed_fwd.cu, fused_embed_bwd.cu): products on
// mma.sync.m16n8k16 (bf16 operands, fp32 sums), ldmatrix B operands,
// movmatrix transposes, cp.async copies and the fixed-order sums that keep
// an fp32 reduction in the plain version's pairwise order.
//
// Fragment layout. A warp owns 16 rows; a thread (lane = 4 g + c) holds, of
// each 16 x 8 fp32 accumulator tile, elements (g, 2c), (g, 2c + 1) in [0],
// [1] and (g + 8, 2c), (g + 8, 2c + 1) in [2], [3]. The A fragment of a
// 16 x 16 k-step is the same layout over two neighbouring tiles rounded to
// bf16, so a result feeds the next product without leaving the registers
// (to_afrag). Each of its four registers is one 8 x 8 bf16 matrix in the
// layout ldmatrix and movmatrix use (thread lane holds row lane / 4,
// columns 2 (lane % 4) and 2 (lane % 4) + 1).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace msst {

// two fp32 values rounded to bf16 and packed in one register, the lower
// column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of the 8 x 8 bf16 matrix whose fragment is a
__device__ __forceinline__ uint32_t movtrans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// B fragments of two neighbouring 8-column tiles (n0, n0 + 8) for the k-step
// at k0, from shared memory by one ldmatrix: r[0], r[1] the first tile's,
// r[2], r[3] the second's. ldsm_kn: B row-major, element (k, n) at
// W[k * ld + n]; ldsm_nk: B stored transposed, element (k, n) at
// W[n * ld + k].
__device__ __forceinline__ void ldsm_kn(uint32_t (&r)[4], const __nv_bfloat16* W, int ld, int k0,
                                        int n0, int lane) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(
      W + (k0 + (lane & 7) + (lane & 8)) * ld + n0 + (lane >> 4) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_nk(uint32_t (&r)[4], const __nv_bfloat16* W, int ld, int k0,
                                        int n0, int lane) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(
      W + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + (lane & 8)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// the A fragments of a [16, 16 KS] operand from the accumulators of its
// 2 KS tiles, rounded to bf16
template <int KS>
__device__ __forceinline__ void to_afrag(uint32_t (&a)[KS][4], const float (&acc)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// 16 bytes from device memory into shared memory by cp.async: the copy
// lands while the thread computes; cp_async_wait_all() (and a barrier for
// the other threads' copies) comes before the first read
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// wait until this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// The sum of N values in a fixed pairwise order: fp32 rounding error that
// grows with log N, as the plain version's tree reductions do.
template <int N>
__device__ __forceinline__ float tree_sum(const float* t) {
  if constexpr (N == 1)
    return t[0];
  else
    return tree_sum<N / 2>(t) + tree_sum<N - N / 2>(t + N / 2);
}

// The sum over a quad (the four lanes that share a row) of each lane's
// pairwise sum of its N values.
template <int N>
__device__ __forceinline__ float quad_sum(const float (&t)[N]) {
  float s = tree_sum<N>(t);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

}  // namespace msst
