// layer_wgrad: the four weight gradients of one pre-norm transformer layer,
// from the bf16 operands that fused_layer_bwd.cu's row kernel writes.
//
// Replaces the weight-gradient products of the Pallas kernel
// maskedsst_tpu/ops/fused_layer.py::_layer_bwd_kernel (dwqkv = h1^T dqkv,
// dwout = o^T dp1, dw1 = h2^T du, dw2 = gd^T dp2, which that kernel sums
// into its outputs over its sequential grid). Numeric contract: the
// operands are the bf16 values the TPU kernel feeds those products; the
// sums are fp32. Only their order differs: within a chunk of rows as the
// tensor cores take them, then the chunks in order, so two calls give the
// same bits (no atomics).
//
// What bounds it on the H100: bytes. Each product is A^T B over the N rows,
// A [N, M] with M in {3I, I, F, F} and B [N, D]: 2 N D (4I + 2F) operations
// against 2 N (4I + 2F + 4D) bytes of operands, 81 FLOP/B at the EnMAP
// widths (D 96, I 512, F 64), below the card's ~295.
//
// What this design does about it:
//  - the products are taken as [M, D] outputs (dwqkv and dw1 transposed on
//    the way out), cut into output tiles of 64 columns of A by all D;
//    every M is a multiple of 16, so a tile is whole 16-column strips;
//  - the grid is (output tile) x (row chunk), tile-fastest, with a fixed
//    number of chunks chosen by the wrapper so that about two blocks per
//    SM are in flight: the blocks that read one chunk's B rows run
//    together and share them in L2; A is read from device memory once;
//  - each block streams its chunk through a 4-stage cp.async ring of
//    [64 rows x 64 A columns] and [64 rows x D] bf16 tiles (zero-filled past
//    the chunk's last row), 90 KB at D = 96, so the next tiles are in
//    flight while the tensor cores work;
//  - 16x16x16 bf16 WMMA products (mma.sync) with the fp32 accumulators in
//    registers for the whole chunk: each of the 4 warps owns a 16 x D strip
//    of the output tile; a chunk's partial tile is stored once;
//  - a second kernel sums the chunks' partials in chunk order into the
//    gradient vector. wgmma is later work: the kernel is bound by bytes.

#include <mma.h>

#include <cstdint>

#include "common.cuh"
#include "layer_grads.cuh"

using namespace msst;
using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // A columns (output rows) per tile
constexpr int kBK = 64;        // rows per pipeline stage
constexpr int kStages = 4;
constexpr int kThreads = 128;  // 4 warps, a 16-row strip of the output tile each
constexpr int kLdA = kBM + 8;  // bf16 row padding: 16-byte rows, banks staggered

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one product: out = A^T B over the rows, A [N, m] and B [N, D] row-major;
// stored at `out` in a chunk's partial row as [m, D], or as [D, m] (trans)
struct Product {
  const bf16* a;
  const bf16* b;
  int m;
  int trans;
  size_t out;
};

// the four products, their first output tiles, and the length of a chunk's
// partial row (the four weight gradients: [D, 3I], [I, D], [D, F], [F, D])
struct Products {
  Product p[4];
  int first_tile[5];
  size_t total;

  Products(const bf16* ops, long long N, int D, int I, int F) {
    const OperandLayout ol(N, D, I, F);
    const size_t qkv = static_cast<size_t>(D) * 3 * I, out = static_cast<size_t>(I) * D,
                 fc1 = static_cast<size_t>(D) * F;
    p[0] = Product{ops + ol.dqkv, ops + ol.h1, 3 * I, 1, 0};
    p[1] = Product{ops + ol.o, ops + ol.dp1, I, 0, qkv};
    p[2] = Product{ops + ol.du, ops + ol.h2, F, 1, qkv + out};
    p[3] = Product{ops + ol.gd, ops + ol.dp2, F, 0, qkv + out + fc1};
    first_tile[0] = 0;
    for (int i = 0; i < 4; ++i) first_tile[i + 1] = first_tile[i] + (p[i].m + kBM - 1) / kBM;
    total = qkv + out + 2 * fc1;
  }
};

template <int NF>  // D = 16 NF
__global__ void __launch_bounds__(kThreads)
layer_wgrad_kernel(const Products ps, float* __restrict__ ws, long long N, int chunk_rows) {
  constexpr int D = 16 * NF, kLdB = D + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);  // [kStages][kBK][kLdA]
  bf16* sb = sa + kStages * kBK * kLdA;          // [kStages][kBK][kLdB]
  const int ntiles = ps.first_tile[4];
  const int tile = blockIdx.x % ntiles, chunk = blockIdx.x / ntiles;
  Product p = ps.p[0];
  int t0 = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (tile >= ps.first_tile[i]) {
      p = ps.p[i];
      t0 = ps.first_tile[i];
    }
  const int m0 = (tile - t0) * kBM;
  const long long r_begin = static_cast<long long>(chunk) * chunk_rows;
  const long long r_end = min(N, r_begin + chunk_rows);
  const int steps = static_cast<int>((r_end - r_begin + kBK - 1) / kBK);
  const int warp = threadIdx.x / 32;
  const bool active = m0 + warp * 16 < p.m;

  auto load = [&](int step, int slot) {
    const long long r0 = r_begin + static_cast<long long>(step) * kBK;
    bf16* da = sa + slot * kBK * kLdA;
    bf16* db = sb + slot * kBK * kLdB;
    constexpr int va = kBM / 8, vb = D / 8;
    for (int i = threadIdx.x; i < kBK * va; i += kThreads) {
      const int r = i / va, c = (i % va) * 8;
      const bool ok = r0 + r < r_end && m0 + c < p.m;
      cp_async16(da + r * kLdA + c, ok ? p.a + (r0 + r) * p.m + m0 + c : p.a, ok);
    }
    for (int i = threadIdx.x; i < kBK * vb; i += kThreads) {
      const int r = i / vb, c = (i % vb) * 8;
      const bool ok = r0 + r < r_end;
      cp_async16(db + r * kLdB + c, ok ? p.b + (r0 + r) * D + c : p.b, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's tiles have landed
    __syncthreads();               // ... for every thread; and the slot refilled below is free
    const int next = step + kStages - 1;
    if (next < steps) load(next, next % kStages);
    cp_async_commit();
    if (active) {
      const bf16* ta = sa + (step % kStages) * kBK * kLdA + warp * 16;
      const bf16* tb = sb + (step % kStages) * kBK * kLdB;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, ta + kk * kLdA, kLdA);  // A^T: (m, r) at [r][m]
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, tb + kk * kLdB + f * 16, kLdB);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = ws + static_cast<size_t>(chunk) * ps.total + p.out;
  const int m = m0 + warp * 16;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (p.trans)  // element (m, n) at out[n * p.m + m]
      wmma::store_matrix_sync(out + static_cast<size_t>(f * 16) * p.m + m, acc[f], p.m,
                              wmma::mem_col_major);
    else
      wmma::store_matrix_sync(out + static_cast<size_t>(m) * D + f * 16, acc[f], D,
                              wmma::mem_row_major);
  }
}

// the weight gradients' entries of the gradient vector: the chunks'
// partial rows summed in chunk order
__global__ void reduce_chunks(const float* __restrict__ ws, float* __restrict__ grads,
                              int nchunks, int D, int I, int F) {
  const GradLayout gl(D, I, F);
  const size_t attn = static_cast<size_t>(D) * 4 * I, fc1 = static_cast<size_t>(D) * F;
  const size_t total = attn + 2 * fc1;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < nchunks; ++c) s += ws[static_cast<size_t>(c) * total + i];
    // dwqkv and dwout are one run of the gradient vector
    const size_t at = i < attn ? gl.wqkv + i
                      : i < attn + fc1 ? gl.w1 + (i - attn)
                                       : gl.w2 + (i - attn - fc1);
    grads[at] = s;
  }
}

template <int NF>
cudaError_t launch(const Products& ps, float* ws, long long N, int chunk_rows, int nchunks,
                   cudaStream_t stream) {
  constexpr int D = 16 * NF;
  const size_t bytes = sizeof(bf16) * kStages * kBK * (kLdA + D + 8);
  auto kernel = layer_wgrad_kernel<NF>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<ps.first_tile[4] * nchunks, kThreads, bytes, stream>>>(ps, ws, N, chunk_rows);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// ops: the bf16 operand buffer of OperandLayout over N rows (16-byte
// aligned); ws: nchunks x D (4I + 2F) floats of chunk partials; grads: the
// layer's fp32 gradient vector (GradLayout), of which the four weight
// gradients are written. Chunk c takes rows [c * chunk_rows, min(N, (c + 1)
// * chunk_rows)); chunk_rows a multiple of 64. D, I and F multiples of 16,
// D at most 128. Launches the product kernel and the reduction on
// `stream`; returns cudaGetLastError().
extern "C" int layer_wgrad(const void* ops, void* ws, void* grads, int N, int D, int I, int F,
                           int chunk_rows, int nchunks, void* stream) {
  if (D % 16 || I % 16 || F % 16 || D < 16 || D > 128 || chunk_rows % kBK || nchunks < 1 ||
      static_cast<long long>(chunk_rows) * nchunks < N ||
      static_cast<long long>(chunk_rows) * (nchunks - 1) >= N || !aligned16(ops))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const Products ps(static_cast<const bf16*>(ops), N, D, I, F);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  switch (D / 16) {
    case 1: err = launch<1>(ps, w, N, chunk_rows, nchunks, st); break;
    case 2: err = launch<2>(ps, w, N, chunk_rows, nchunks, st); break;
    case 3: err = launch<3>(ps, w, N, chunk_rows, nchunks, st); break;
    case 4: err = launch<4>(ps, w, N, chunk_rows, nchunks, st); break;
    case 5: err = launch<5>(ps, w, N, chunk_rows, nchunks, st); break;
    case 6: err = launch<6>(ps, w, N, chunk_rows, nchunks, st); break;
    case 7: err = launch<7>(ps, w, N, chunk_rows, nchunks, st); break;
    default: err = launch<8>(ps, w, N, chunk_rows, nchunks, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(D) * (4 * I + 2 * F);
  reduce_chunks<<<static_cast<int>((total + 255) / 256), 256, 0, st>>>(w, static_cast<float*>(grads),
                                                                     nchunks, D, I, F);
  return static_cast<int>(cudaGetLastError());
}
