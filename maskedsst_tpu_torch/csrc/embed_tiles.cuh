// The tensor-core forms of the fused embed (fused_embed_fwd.cu,
// fused_embed_bwd.cu) share their tiling: one warp per 16 tokens of one
// (b, g), blocks of four warps over one g, up to 64 tokens and a chunk of b
// (Walk), and the pre-LN over p computed in the A-fragment layout of the
// m16n8k16 product (warp_mma.cuh), p padded to 16 by zeros.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "warp_mma.cuh"

namespace msst {

constexpr int kWarps = 4;  // 16-token tiles (warps) a block
constexpr int kTcThreads = 32 * kWarps;
constexpr int kPad = 8;  // bf16 row padding: 16-byte rows, ldmatrix free of bank conflicts

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// The widths the tensor-core form takes (ops/fused_embed.py::_tc_form).
__host__ __device__ inline bool tc_widths(int P, int D) {
  return P >= 1 && P <= 16 && D >= 8 && D % 8 == 0 && D <= 128;
}

// The block's tiles and chunk of b. The grid is G x groups x chunks: block
// (g, group, chunk) takes tokens [64 group, 64 group + 64) of block g and
// b in [per chunk, per chunk + per). Of its kWarps warps, warp w takes
// tile w % nt of the group's nt tiles and every wpt-th b from w / nt on.
struct Walk {
  int g, row0, nt, rows, b_lo, b_hi, tile, boff, wpt;
  bool active;

  __device__ Walk(int B, int G, int N, int per, int chunks) {
    const int tiles = (N + 15) / 16, groups = (tiles + kWarps - 1) / kWarps;
    const int chunk = blockIdx.x % chunks, rest = blockIdx.x / chunks;
    const int group = rest % groups;
    g = rest / groups;
    row0 = group * 16 * kWarps;
    nt = min(kWarps, tiles - group * kWarps);
    rows = min(N - row0, 16 * nt);
    b_lo = chunk * per;
    b_hi = min(B, b_lo + per);
    const int warp = threadIdx.x / 32;
    wpt = kWarps / nt;
    tile = warp % nt;
    boff = warp / nt;
    active = warp < nt * wpt;
  }
};


// The lane's pixels of one (b, g) for the quad's tokens (row a = r, row b =
// r + 8 of the tile) at p = 2c, 2c + 1, 2c + 8, 2c + 9: px[2k + h] for p
// index k and row h; 0 past P and past N.
template <typename Tin>
__device__ __forceinline__ void load_pixels(float (&px)[8], const Tin* __restrict__ pat, int P,
                                            int N, int na, int c) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = 2 * c + (k & 1) + 8 * (k >> 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = na + 8 * h;
      px[2 * k + h] = p < P && n < N ? to_f(pat[p * N + n]) : 0.f;
    }
  }
}

// The pre-LN over p of the quad's two tokens: z1 (fp32, 0 past P) into
// z[2k + h] and xln = z1 * scale + bias rounded to bf16 as the m16k16 A
// fragment of the tile (p padded to 16 by zeros). Statistics in fp32 by
// quad shuffles; a mean is the sum times fl(1/P), separate roundings where
// the plain version rounds twice.
__device__ __forceinline__ void pre_ln(uint32_t (&a)[4], float (&z)[8], const float (&px)[8],
                                       const float (&sc)[4], const float (&bi)[4], int P,
                                       int c) {
  const float inv_p = 1.f / P;
  float xl[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = px[2 * k + h];
    const float mu = __fmul_rn(quad_sum(t), inv_p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 2 * c + (k & 1) + 8 * (k >> 1);
      const float d = __fsub_rn(px[2 * k + h], mu);
      t[k] = p < P ? __fmul_rn(d, d) : 0.f;
    }
    const float rsig = rsqrtf(__fadd_rn(__fmul_rn(quad_sum(t), inv_p), kLnEps));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 2 * c + (k & 1) + 8 * (k >> 1);
      const float zz = __fmul_rn(__fsub_rn(px[2 * k + h], mu), rsig);
      z[2 * k + h] = p < P ? zz : 0.f;
      xl[2 * k + h] = p < P ? __fadd_rn(__fmul_rn(zz, sc[k]), bi[k]) : 0.f;
    }
  }
  a[0] = pack_bf16(xl[0], xl[2]);  // row a, p 2c and 2c + 1
  a[1] = pack_bf16(xl[1], xl[3]);  // row b
  a[2] = pack_bf16(xl[4], xl[6]);  // row a, p 2c + 8 and 2c + 9
  a[3] = pack_bf16(xl[5], xl[7]);  // row b
}

// the LN vectors' entries at the lane's p, 0 past P
__device__ __forceinline__ void lane_p(float (&v)[4], const float* __restrict__ src, int P, int c) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = 2 * c + (k & 1) + 8 * (k >> 1);
    v[k] = p < P ? src[p] : 0.f;
  }
}

__host__ inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace msst
