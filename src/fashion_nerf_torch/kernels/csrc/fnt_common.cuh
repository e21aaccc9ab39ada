// Shared device code of the field kernels: the packed-weight layout and the
// numerics helpers (every kernel), and the shared-memory slab, the wmma
// layer loop and the per-tile predication of the generic carry march
// (carrymarch.cu), the one kernel still on this loop. The wgmma kernels
// (sigmamarch.cu, slimmarch.cu, field.cu, field_bwd.cu) have their own
// loop in wg_trunk.cuh and wg_field.cuh.
//
// A CUDA block of the slab kernels evaluates one slab of kRows MLP rows. The slab's activations
// stay in shared memory across every layer (two bf16 ping-pong buffers plus
// the posenc operand); weights are read from device memory. By its shapes
// the whole 8x256 field is 0.59M bf16 weights, small against the L2.
//
// Numerics follow the reference kernels: every matrix product takes bf16
// operands (rounded to nearest even) and accumulates in f32 on the tensor
// cores (nvcuda::wmma 16x16x16); activations are rounded back to bf16 after
// the relu; posenc phases, hoisted per-ray terms and the transmittance
// prefix stay f32. Products that must not be contracted into an FMA (so that
// the plain PyTorch version rounds the same way) use __fmul_rn/__fadd_rn.
// Build without --use_fast_math: phases reach 2^9·|x| ≈ 1e3 rad, where the
// fast __sinf is wrong.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace fnt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kRows = 64;             // MLP rows per CUDA block (one slab)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWidth = 256;
constexpr int kMaxDepth = 16;
constexpr int kMaxK0 = 64;            // padded width of the posenc operand
constexpr int kLdH = kMaxWidth + 8;   // bf16 row stride of activation buffers
constexpr int kLdA = kMaxK0 + 8;      // bf16 row stride of the posenc operand
constexpr int kTileRows = 2048;       // rows of one predication tile
constexpr float kLogFloor = -23.025851f;   // log(1e-10) floor on log(1-α)
constexpr float kHalfPi = 1.57079632679489661923f;  // == float32(pi / 2)

// Offsets (in elements) of every tensor in the flat bf16 weight buffer and
// the flat f32 bias buffer. Must equal kernels/posenc_mlp.py::_layout.
struct Layout {
  int depth, width, k0, skip, has_vd;
  int w_h[kMaxDepth];    // h-kernel of layer i (width x width), -1 if none
  int w_a0[kMaxDepth];   // posenc-operand kernel of layer i (k0 x width), -1
  int b[kMaxDepth];      // bias of layer i (width)
  int w_sig, w_feat, w_view, w_rgb, w_out;
  int b_sig, b_feat, b_view, b_rgb, b_out;
};

inline Layout make_layout(int depth, int width, int k0, int skip,
                          int has_vd) {
  Layout L{};
  L.depth = depth; L.width = width; L.k0 = k0; L.skip = skip;
  L.has_vd = has_vd;
  int wo = 0, bo = 0;
  for (int i = 0; i < depth; ++i) {
    L.w_h[i] = -1; L.w_a0[i] = -1;
    if (i == 0) {
      L.w_a0[i] = wo; wo += k0 * width;
    } else if (i == skip) {
      L.w_h[i] = wo; wo += width * width;
      L.w_a0[i] = wo; wo += k0 * width;
    } else {
      L.w_h[i] = wo; wo += width * width;
    }
    L.b[i] = bo; bo += width;
  }
  L.w_sig = L.w_feat = L.w_view = L.w_rgb = L.w_out = -1;
  L.b_sig = L.b_feat = L.b_view = L.b_rgb = L.b_out = -1;
  if (has_vd) {
    L.w_sig = wo; wo += width;
    L.w_feat = wo; wo += width * width;
    L.w_view = wo; wo += width * (width / 2);
    L.w_rgb = wo; wo += (width / 2) * 3;
    L.b_sig = bo; bo += 1;
    L.b_feat = bo; bo += width;
    L.b_view = bo; bo += width / 2;
    L.b_rgb = bo; bo += 3;
  } else {
    L.w_out = wo; wo += width * 4;
    L.b_out = bo; bo += 4;
  }
  return L;
}

// Checks the host can launch the slab kernels for this layout; 0 if fine.
inline int layout_error(const Layout& L) {
  if (L.depth < 1 || L.depth > kMaxDepth) return 1;
  if (L.width < 16 || L.width > kMaxWidth || L.width % 32) return 1;
  if (L.k0 < 16 || L.k0 > kMaxK0 || L.k0 % 16) return 1;
  return 0;
}

struct __align__(128) Smem {
  bf16 h[2][kRows * kLdH];      // ping-pong activations
  bf16 a0[kRows * kLdA];        // posenc operand [x? | sin | cos | 0-pad]
  float scratch[kWarps][256];   // one 16x16 f32 accumulator tile per warp
  float row_t[kRows];           // sample position of each row
  float row_sigma[kRows];       // raw σ of each row
  float row_rgb[kRows][3];      // post-sigmoid rgb of each row
};

// The block's dynamic shared memory, seen as one Smem.
__device__ __forceinline__ Smem& smem() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return *reinterpret_cast<Smem*>(smem_raw);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float density(float sigma, int softplus) {
  if (softplus) return sigma > 20.0f ? sigma : log1pf(expf(sigma));
  return fmaxf(sigma, 0.0f);
}

// Predication of the multi-block marches: nonzero in every thread iff some
// ray of the tile that starts at ray tile0 (rpt rays) is alive at sample
// block blk, i.e. hit ∧ block_hit[blk] ∧ logT > log ε (logT = 0 before the
// first block). Every thread of the block must call it.
__device__ __forceinline__ int tile_alive(const float* hit,
                                          const float* block_hit,
                                          const float* logT_in, long tile0,
                                          int rpt, int NB, int blk,
                                          float log_eps) {
  int live = 0;
  for (int i = threadIdx.x; i < rpt; i += kThreads) {
    const long ray = tile0 + i;
    const float lt = blk == 0 ? 0.0f : logT_in[ray];
    live |= hit[ray] > 0.0f && block_hit[ray * NB + blk] > 0.0f &&
            lt > log_eps;
  }
  return __syncthreads_or(live);
}

// C = A1·B1 (+ A2·B2) over the slab's kRows rows, N output columns, then
// epi(row, col, value) on every element. A* are bf16 in shared memory
// (row stride lda*), B* bf16 row-major (K x N) in device memory. Each warp
// owns whole 16-column strips; the accumulator tile goes through the warp's
// scratch so the epilogue sees (row, col) coordinates.
template <class Epi>
__device__ __forceinline__ void mma_rows(const bf16* A1, int lda1, int K1,
                                         const bf16* B1, const bf16* A2,
                                         int lda2, int K2, const bf16* B2,
                                         int N, Epi epi) {
  Smem& s = smem();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = s.scratch[warp];
  for (int ct = warp; ct * 16 < N; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRows / 16];
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) wmma::fill_fragment(acc[m], 0.0f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
    for (int k = 0; k < K1; k += 16) {
      wmma::load_matrix_sync(fb, B1 + (size_t)k * N + ct * 16, N);
#pragma unroll
      for (int m = 0; m < kRows / 16; ++m) {
        wmma::load_matrix_sync(fa, A1 + m * 16 * lda1 + k, lda1);
        wmma::mma_sync(acc[m], fa, fb, acc[m]);
      }
    }
    for (int k = 0; k < K2; k += 16) {
      wmma::load_matrix_sync(fb, B2 + (size_t)k * N + ct * 16, N);
#pragma unroll
      for (int m = 0; m < kRows / 16; ++m) {
        wmma::load_matrix_sync(fa, A2 + m * 16 * lda2 + k, lda2);
        wmma::mma_sync(acc[m], fa, fb, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) {
      wmma::store_matrix_sync(scratch, acc[m], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        epi(m * 16 + (e >> 4), ct * 16 + (e & 15), scratch[e]);
      __syncwarp();
    }
  }
}

// The trunk on the slab. s.a0 holds the posenc operand. xterm(l, r, c) is
// the hoisted f32 term of the l-th posenc-consuming layer (first, skip) at
// row r, column c (0 where nothing is hoisted). Returns the index of the
// activation buffer that holds the last trunk layer's output.
template <class XTerm>
__device__ int run_trunk(const Layout& L, const bf16* w, const float* b,
                         XTerm xterm) {
  Smem& s = smem();
  int cur = 1;
  int xi = 0;
  for (int i = 0; i < L.depth; ++i) {
    const int out = cur ^ 1;
    bf16* H = s.h[out];
    const bf16* Hin = s.h[cur];
    const int xl = L.w_a0[i] >= 0 ? xi++ : -1;
    const float* bias = b + L.b[i];
    auto epi = [&](int r, int c, float v) {
      v = __fadd_rn(v, bias[c]);
      if (xl >= 0) v = __fadd_rn(v, xterm(xl, r, c));
      H[r * kLdH + c] = __float2bfloat16_rn(fmaxf(v, 0.0f));
    };
    if (L.w_h[i] >= 0 && L.w_a0[i] >= 0)
      mma_rows(Hin, kLdH, L.width, w + L.w_h[i], s.a0, kLdA, L.k0,
               w + L.w_a0[i], L.width, epi);
    else if (L.w_h[i] >= 0)
      mma_rows(Hin, kLdH, L.width, w + L.w_h[i], nullptr, 0, 0, nullptr,
               L.width, epi);
    else
      mma_rows(s.a0, kLdA, L.k0, w + L.w_a0[i], nullptr, 0, 0, nullptr,
               L.width, epi);
    __syncthreads();
    cur = out;
  }
  return cur;
}

// The heads on the slab's trunk output s.h[cur]: writes s.row_sigma (raw σ)
// and s.row_rgb (post-sigmoid). dir(r, c) is the per-ray view-branch term
// (γ(d)·W_dir, bf16-valued) of row r, used only with a view branch.
template <class DirTerm>
__device__ void run_heads(const Layout& L, const bf16* w, const float* b,
                          int cur, DirTerm dir) {
  Smem& s = smem();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = L.width;
  bf16* H = s.h[cur];
  if (L.has_vd) {
    for (int r = warp; r < kRows; r += kWarps) {
      float a = 0.0f;
      for (int k = lane; k < W; k += 32)
        a = fmaf(bf(H[r * kLdH + k]), bf(w[L.w_sig + k]), a);
      a = warp_sum(a);
      if (lane == 0) s.row_sigma[r] = a + b[L.b_sig];
    }
    bf16* Fe = s.h[cur ^ 1];
    const float* b_feat = b + L.b_feat;
    mma_rows(H, kLdH, W, w + L.w_feat, nullptr, 0, 0, nullptr, W,
             [&](int r, int c, float v) {
               Fe[r * kLdH + c] = __float2bfloat16_rn(__fadd_rn(v,
                                                                b_feat[c]));
             });
    __syncthreads();
    const float* b_view = b + L.b_view;
    mma_rows(Fe, kLdH, W, w + L.w_view, nullptr, 0, 0, nullptr, W / 2,
             [&](int r, int c, float v) {
               v = __fadd_rn(__fadd_rn(v, dir(r, c)), b_view[c]);
               H[r * kLdH + c] = __float2bfloat16_rn(fmaxf(v, 0.0f));
             });
    __syncthreads();
    const bf16* wr = w + L.w_rgb;
    for (int r = warp; r < kRows; r += kWarps) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      for (int k = lane; k < W / 2; k += 32) {
        const float hv = bf(H[r * kLdH + k]);
        a0 = fmaf(hv, bf(wr[k * 3 + 0]), a0);
        a1 = fmaf(hv, bf(wr[k * 3 + 1]), a1);
        a2 = fmaf(hv, bf(wr[k * 3 + 2]), a2);
      }
      a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2);
      if (lane == 0) {
        s.row_rgb[r][0] = sigmoidf(a0 + b[L.b_rgb + 0]);
        s.row_rgb[r][1] = sigmoidf(a1 + b[L.b_rgb + 1]);
        s.row_rgb[r][2] = sigmoidf(a2 + b[L.b_rgb + 2]);
      }
    }
  } else {
    const bf16* wo = w + L.w_out;
    for (int r = warp; r < kRows; r += kWarps) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = lane; k < W; k += 32) {
        const float hv = bf(H[r * kLdH + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = fmaf(hv, bf(wo[k * 4 + j]), a[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = warp_sum(a[j]);
      if (lane == 0) {
        for (int j = 0; j < 3; ++j)
          s.row_rgb[r][j] = sigmoidf(a[j] + b[L.b_out + j]);
        s.row_sigma[r] = a[3] + b[L.b_out + 3];
      }
    }
  }
  __syncthreads();
}

// sizeof(Smem) is over the default dynamic shared-memory limit (48 KiB).
template <class K>
inline cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem));
}

}  // namespace fnt
