// The tensor-core forms of the SimMIM decode + weighted L1
// (fused_simmim_fwd.cu, fused_simmim_bwd.cu) share their tiling with the
// embed's (embed_tiles.cuh Walk: one warp per 16 tokens of one (b, g),
// blocks of four warps over one g, up to 64 tokens and a chunk of b) and
// what is added here: the shared-memory plan, the warp's staged [16, D] bf16
// slab of encoded, its A fragments by ldmatrix (plain for the decode, .trans
// for the encoded^T operand of d kernel) and cp.async groups, so that the
// next b's slab lands while this b's is used.
//
// The decode is preds [16 tokens, 16 q] = enc [16, D] . kern [D, 16] on
// mma.sync.m16n8k16 (warp_mma.cuh), q padded to 16 by zero columns of the
// kernel slice. Its C fragments give the lane token rows lane / 4 (+ 8) and
// q = 2c, 2c + 1, 2c + 8, 2c + 9 (c = lane % 4): the pixel layout of
// embed_tiles.cuh load_pixels, whose px[2k + h] is q index k, row h.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "embed_tiles.cuh"
#include "warp_mma.cuh"

namespace msst {

// The widths the tensor-core forms take (ops/fused_simmim.py::_tc_form):
// P at most 16 (the decode's N, padded to 16), D a multiple of 16 (the
// decode's K steps and d kernel's M tiles) up to 128.
__host__ __device__ inline bool decode_tc_widths(int P, int D) {
  return P >= 1 && P <= 16 && D >= 16 && D % 16 == 0 && D <= 128;
}

// Resident blocks per SM that both forms' register budgets allow
// (__launch_bounds__; ops/fused_simmim.py TC_BLOCKS_PER_SM).
constexpr int kDecodeBlocksPerSm = 3;

// Byte offsets of the forms' shared memory: the kernel slice [D, 16 + kPad]
// bf16 (columns q >= P zero) and each warp's two slab buffers [16, D + kPad]
// bf16. The backward's block sums reuse the slabs at its end.
struct DecodePlan {
  int ld_k, ld;
  size_t kern, slab, bytes;

  __host__ __device__ explicit DecodePlan(int D) {
    ld_k = 16 + kPad;
    ld = D + kPad;
    size_t off = 0;
    kern = off; off += align128(sizeof(__nv_bfloat16) * D * ld_k);
    slab = off; off += align128(sizeof(__nv_bfloat16) * kWarps * 2 * 16 * ld);
    bytes = off;
  }
};

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The warp's [rows, D] slab of encoded (rows contiguous in device memory)
// into its bf16 shared rows (stride ld). bf16: 16-byte cp.async pieces that
// land later (the caller commits, waits and syncs the warp); fp32: 16-byte
// loads rounded to bf16 and stored now.
__device__ __forceinline__ void stage_slab(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* __restrict__ src, int rows, int D,
                                           int lane) {
  const int cpr = D / 8;
  for (int k = lane; k < rows * cpr; k += 32) {
    const int r = k / cpr, piece = k - r * cpr;
    cp_async16(dst + r * ld + 8 * piece, src + 8 * k);
  }
}

__device__ __forceinline__ void stage_slab(__nv_bfloat16* dst, int ld,
                                           const float* __restrict__ src, int rows, int D,
                                           int lane) {
  const int cpr = D / 4;
  for (int k = lane; k < rows * cpr; k += 32) {
    const int r = k / cpr, piece = k - r * cpr;
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + k);
    *reinterpret_cast<uint2*>(dst + r * ld + 4 * piece) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// The A fragment of the k-step at column k0 of a row-major [16, *] bf16
// tile T (element (m, k) at T[m * ld + k]).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* T, int ld, int k0,
                                       int lane) {
  const unsigned addr = static_cast<unsigned>(
      __cvta_generic_to_shared(T + (lane & 15) * ld + k0 + (lane >> 4) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The A fragment of the [16, 16] tile at rows m0 of T^T, T a row-major
// [16, *] bf16 tile (element (m, k) of the operand at T[k * ld + m0 + m]).
__device__ __forceinline__ void ldsm_at(uint32_t (&a)[4], const __nv_bfloat16* T, int ld, int m0,
                                        int lane) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      T + ((lane & 7) + ((lane >> 4) << 3)) * ld + m0 + ((lane >> 3) & 1) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The kernel slice of block g into ks [D, ld_k] bf16, columns q >= P zero.
// The loads are unrolled, so that several are in flight at once.
__device__ __forceinline__ void stage_kern(__nv_bfloat16* ks, int ld_k,
                                           const __nv_bfloat16* __restrict__ kern, int g, int D,
                                           int P) {
  const __nv_bfloat16* src = kern + static_cast<size_t>(g) * D * P;
#pragma unroll 4
  for (int i = threadIdx.x; i < D * P; i += blockDim.x) ks[(i / P) * ld_k + i % P] = src[i];
  const int zq = 16 - P;
  for (int i = threadIdx.x; i < D * zq; i += blockDim.x)
    ks[(i / zq) * ld_k + P + i % zq] = __float2bfloat16(0.f);
}

// Zero the rows at and past `rows` of the warp's two slab buffers: no copy
// writes them, and a ragged tile's products must read zeros there.
__device__ __forceinline__ void zero_tail(__nv_bfloat16* slabs, int ld, int rows, int lane) {
  for (int i = rows * ld + lane; i < 16 * ld; i += 32) {
    slabs[i] = __float2bfloat16(0.f);
    slabs[16 * ld + i] = __float2bfloat16(0.f);
  }
}

// The lane's targets of one (b, g): the pixels of its tokens na, na + 8 at
// its q's (load_pixels) and the tokens' loss weights, 0 past N.
__device__ __forceinline__ void load_targets(float (&px)[8], float (&wv)[2],
                                             const float* __restrict__ pat,
                                             const float* __restrict__ wrow, int P, int N,
                                             int na, int c) {
  load_pixels(px, pat, P, N, na, c);
  wv[0] = na < N ? wrow[na] : 0.f;
  wv[1] = na + 8 < N ? wrow[na + 8] : 0.f;
}

}  // namespace msst
