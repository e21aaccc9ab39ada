// Fused posenc + NeRF-MLP field, backward (kernel K4).
//
// Replaces: src/fashion_nerf/kernels/posenc_mlp_pallas.py::_field_bwd_kernel
// (via _fused_bwd_eval / _pallas_backward), the TPU kernel that recomputes
// the forward of a 512-row tile in VMEM, backprops it, and accumulates the
// weight gradients across its sequential grid into one VMEM output.
//
// What bounds it on the H100: bf16 matrix products again, three times the
// forward's (recompute, dgrad, wgrad: ~3.2 MFLOP per row of the 8x256
// field), plus the bytes of the workspace below (~10 KB per row written once
// and read once).
//
// Design. Blocks run in parallel and in no order, so the TPU's carried wgrad
// sum has no counterpart; and a block's shared memory cannot hold a
// 64-row slab's eight trunk activations (8 x 33 KB) next to its working
// buffers. So K4 is four kernels, launched per pass of up to `chunk` rows:
//  1. bwd_rows_kernel, one block per 64-row slab (as K3): recomputes the
//     forward, writing every layer's bf16 input/output to a global
//     workspace; backprops the heads and the trunk in reverse with bf16
//     dgrad products on the tensor cores (nvcuda::wmma, f32 accumulation),
//     relu masks read back from the stored activations, writing every
//     bf16-rounded pre-activation cotangent to the workspace; backprops the
//     posenc phases into d_pts; and writes its bias-gradient column sums
//     and its per-ray view-term cotangent sums as per-slab partials.
//  2. wgrad_kernel: every weight gradient A^T·D over the pass's rows, one
//     64x64 output tile per block and a fixed split of the rows per
//     blockIdx.y, into per-split partials.
//  3. sum_rows_kernel: the partials summed in a fixed order into the
//     outputs (weights over splits, biases over slabs), added to what the
//     earlier passes left there.
//  4. After the last pass, dir_sum_kernel sums each ray's slab partials.
// No float atomics anywhere: the same inputs give bitwise the same
// gradients, so a resumed run retraces its trajectory.
//
// Rounding points follow the reference (posenc_mlp_pallas.py:724-801):
// cotangents of pre-activations are rounded to bf16 as the operands of both
// products, accumulation is f32, bias gradients are f32 sums of the
// unrounded cotangents (of the rounded ones for the rgb head, the feature
// layer and the no-view-branch head, as the reference sums those after
// rounding), sin/cos are f32.
#include <type_traits>

#include "fnt_common.cuh"

namespace fnt {

constexpr int kMaxProds = 2 * kMaxDepth + 4;
constexpr int kHead = 16;       // padded width of the head cotangents
constexpr int kWTile = 64;      // wgrad output tile (rows and columns)
constexpr int kWRows = 32;      // rows of the reduction per wgrad stage

// Column offsets of the workspace regions (each region is `rows` x width,
// row-major). Must equal kernels/posenc_mlp.py::bwd_workspace_cols.
struct Regions {
  long a0, h[kMaxDepth], feat, h2, dpre[kMaxDepth], dfeat, dh2, draw, dsig;
  long cols;
};

inline Regions make_regions(const Layout& L) {
  Regions g{};
  const int W = L.width, half = W / 2;
  long c = 0;
  g.a0 = c; c += L.k0;
  for (int i = 0; i < L.depth; ++i) { g.h[i] = c; c += W; }
  g.feat = c; c += W;
  g.h2 = c; c += half;
  for (int i = 0; i < L.depth; ++i) { g.dpre[i] = c; c += W; }
  g.dfeat = c; c += W;
  g.dh2 = c; c += half;
  g.draw = c; c += kHead;
  g.dsig = c; c += kHead;
  g.cols = c;
  return g;
}

struct __align__(128) BwdSmem {
  bf16 h[2][kRows * kLdH];        // activations, then cotangents
  bf16 a0[kRows * kLdA];          // posenc operand
  float scratch[kWarps][256];     // one 16x16 f32 tile per warp
  float d_a0[kRows * kMaxK0];     // f32 cotangent of the posenc operand
  float rgb[kRows][3];            // post-sigmoid rgb
  float d_raw[kRows][4];          // bf16-valued head cotangents
  float gs[kRows];                // σ cotangent
};

__device__ __forceinline__ BwdSmem& bsm() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return *reinterpret_cast<BwdSmem*>(smem_raw);
}

// C = A1·B1 (+ A2·B2) over the slab's kRows rows and N output columns,
// then v' = epi(r, c, v) on every element; colsum(c, Σ_r v') once per
// column, summed in a fixed order (each lane over its rows, then the lane
// pair). A* are bf16 in shared memory (row strides lda*, K* columns). B*
// are bf16 in device memory, row-major K x N with row stride ldb, or with
// BT given transposed: element (k, n) at B[n * ldb + k] (the dgrad
// products read the forward's weights this way).
template <bool BT, class Epi, class ColSum>
__device__ __forceinline__ void mma_slab(const bf16* A1, int lda1, int K1,
                                         const bf16* B1, const bf16* A2,
                                         int lda2, int K2, const bf16* B2,
                                         int ldb, int N, Epi epi,
                                         ColSum colsum) {
  using BLay = typename std::conditional<BT, wmma::col_major,
                                         wmma::row_major>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = bsm().scratch[warp];
  for (int ct = warp; ct * 16 < N; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRows / 16];
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) wmma::fill_fragment(acc[m], 0.0f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLay> fb;
    for (int op = 0; op < 2; ++op) {
      const bf16* A = op ? A2 : A1;
      const bf16* B = op ? B2 : B1;
      const int lda = op ? lda2 : lda1, K = op ? K2 : K1;
      for (int k = 0; k < K; k += 16) {
        const bf16* bp = BT ? B + (size_t)ct * 16 * ldb + k
                            : B + (size_t)k * ldb + ct * 16;
        wmma::load_matrix_sync(fb, bp, ldb);
#pragma unroll
        for (int m = 0; m < kRows / 16; ++m) {
          wmma::load_matrix_sync(fa, A + m * 16 * lda + k, lda);
          wmma::mma_sync(acc[m], fa, fb, acc[m]);
        }
      }
    }
    // lane's column within the strip is lane & 15 for every element it
    // visits (e = lane + 32j), so its partial column sum needs no sharing
    float part = 0.0f;
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) {
      wmma::store_matrix_sync(scratch, acc[m], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        part += epi(m * 16 + (e >> 4), ct * 16 + (e & 15), scratch[e]);
      __syncwarp();
    }
    part += __shfl_xor_sync(0xffffffffu, part, 16);
    if (lane < 16) colsum(ct * 16 + lane, part);
  }
}

// One product A·B (see above).
template <bool BT, class Epi, class ColSum>
__device__ __forceinline__ void mma_one(const bf16* A, int lda, int K,
                                        const bf16* B, int ldb, int N,
                                        Epi epi, ColSum colsum) {
  mma_slab<BT>(A, lda, K, B, nullptr, 0, 0, nullptr, ldb, N, epi, colsum);
}

// Copy a slab (kRows x width bf16, shared row stride lds) to the workspace.
__device__ __forceinline__ void store_slab(const bf16* src, int lds,
                                           bf16* dst, int width) {
  const int vpr = width / 8;
  for (int i = threadIdx.x; i < kRows * vpr; i += kThreads) {
    const int r = i / vpr, v = i % vpr;
    *reinterpret_cast<uint4*>(dst + (size_t)r * width + v * 8) =
        *reinterpret_cast<const uint4*>(src + r * lds + v * 8);
  }
}

struct RowsArgs {
  const float* pts;      // (n, 3)
  const bf16* dirpart;   // (n / spr, width / 2)
  const bf16* w;
  const float* b;
  const float* g_rgb;    // (n, 3)
  const float* g_sigma;  // (n,)
  float* d_pts;          // (n, 3)
  float* dpart;          // (n / kRows, M, width / 2) per-slab ray sums
  float* bpart;          // (chunk / kRows, n_b) per-slab bias sums
  bf16* ws;              // workspace, regions of `rows` rows
  long rows;             // rows of the pass (region height)
  int slab0;             // first slab of the pass
  int spr, L, M, n_b;
  Layout lay;
  Regions reg;
};

__global__ void __launch_bounds__(kThreads) bwd_rows_kernel(RowsArgs a) {
  BwdSmem& s = bsm();
  const Layout& lay = a.lay;
  const int W = lay.width, half = W / 2, D = lay.depth;
  const int slab = a.slab0 + blockIdx.x;
  const long row0 = (long)slab * kRows;            // global row
  const long lrow0 = (long)blockIdx.x * kRows;     // row in the pass
  // a slab's rows in the region at column offset col (width columns)
  auto slab_of = [&](long col, int width) {
    return a.ws + col * a.rows + lrow0 * width;
  };
  float* bsum = a.bpart + (long)blockIdx.x * a.n_b;

  // ---- posenc operand (as K3), and the cotangent accumulator
  const int n_ph = 6 * a.L;
  for (int i = threadIdx.x; i < kRows * lay.k0; i += kThreads) {
    const int r = i / lay.k0, c = i % lay.k0;
    float v = 0.0f;
    if (c < 3) {
      v = a.pts[(row0 + r) * 3 + c];
    } else if (c < 3 + n_ph) {
      const int j = (c - 3) / 3, k = (c - 3) % 3;
      const float f = (float)(1 << (j % a.L));
      const float off = j >= a.L ? kHalfPi : 0.0f;
      v = sinf(__fadd_rn(__fmul_rn(a.pts[(row0 + r) * 3 + k], f), off));
    }
    s.a0[r * kLdA + c] = __float2bfloat16_rn(v);
    s.d_a0[r * kMaxK0 + c] = 0.0f;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    s.gs[r] = a.g_sigma[row0 + r];
  __syncthreads();
  store_slab(s.a0, kLdA, slab_of(a.reg.a0, lay.k0), lay.k0);

  auto no_sum = [](int, float) {};
  // ---- forward recompute of the trunk; every output to the workspace
  int cur = 1;
  for (int i = 0; i < D; ++i) {
    const int out = cur ^ 1;
    bf16* H = s.h[out];
    const float* bias = a.b + lay.b[i];
    auto epi = [&](int r, int c, float v) {
      H[r * kLdH + c] = __float2bfloat16_rn(fmaxf(__fadd_rn(v, bias[c]),
                                                  0.0f));
      return 0.0f;
    };
    // the skip layer sums h·W_h and a0·W_a0 in one accumulator, as K3
    if (lay.w_h[i] >= 0 && lay.w_a0[i] >= 0)
      mma_slab<false>(s.h[cur], kLdH, W, a.w + lay.w_h[i], s.a0, kLdA,
                      lay.k0, a.w + lay.w_a0[i], W, W, epi, no_sum);
    else if (lay.w_h[i] >= 0)
      mma_one<false>(s.h[cur], kLdH, W, a.w + lay.w_h[i], W, W, epi, no_sum);
    else
      mma_one<false>(s.a0, kLdA, lay.k0, a.w + lay.w_a0[i], W, W, epi,
                     no_sum);
    __syncthreads();
    store_slab(H, kLdH, slab_of(a.reg.h[i], W), W);
    cur = out;
  }
  // s.h[cur] = h_{D-1}

  if (lay.has_vd) {
    // ---- heads forward: feat, h2, rgb (σ is not needed: its head is the
    // identity and its cotangent is g_sigma)
    bf16* Fe = s.h[cur ^ 1];
    const float* b_feat = a.b + lay.b_feat;
    mma_one<false>(s.h[cur], kLdH, W, a.w + lay.w_feat, W, W,
                    [&](int r, int c, float v) {
                      Fe[r * kLdH + c] =
                          __float2bfloat16_rn(__fadd_rn(v, b_feat[c]));
                      return 0.0f;
                    }, no_sum);
    __syncthreads();
    store_slab(Fe, kLdH, slab_of(a.reg.feat, W), W);
    bf16* H2 = s.h[cur];
    const float* b_view = a.b + lay.b_view;
    mma_one<false>(Fe, kLdH, W, a.w + lay.w_view, half, half,
                    [&](int r, int c, float v) {
                      const float d = bf(a.dirpart[((row0 + r) / a.spr) *
                                                   half + c]);
                      v = __fadd_rn(__fadd_rn(v, d), b_view[c]);
                      H2[r * kLdH + c] = __float2bfloat16_rn(fmaxf(v, 0.0f));
                      return 0.0f;
                    }, no_sum);
    __syncthreads();
    store_slab(H2, kLdH, slab_of(a.reg.h2, half), half);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bf16* wr = a.w + lay.w_rgb;
    for (int r = warp; r < kRows; r += kWarps) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      for (int k = lane; k < half; k += 32) {
        const float hv = bf(H2[r * kLdH + k]);
        a0 = fmaf(hv, bf(wr[k * 3 + 0]), a0);
        a1 = fmaf(hv, bf(wr[k * 3 + 1]), a1);
        a2 = fmaf(hv, bf(wr[k * 3 + 2]), a2);
      }
      a0 = warp_sum(a0); a1 = warp_sum(a1); a2 = warp_sum(a2);
      if (lane == 0) {
        s.rgb[r][0] = sigmoidf(a0 + a.b[lay.b_rgb + 0]);
        s.rgb[r][1] = sigmoidf(a1 + a.b[lay.b_rgb + 1]);
        s.rgb[r][2] = sigmoidf(a2 + a.b[lay.b_rgb + 2]);
      }
    }
    __syncthreads();

    // ---- rgb head: d_raw = bf16(g·s·(1−s)); σ head: bf16(g_sigma)
    bf16* draw = slab_of(a.reg.draw, kHead);
    bf16* dsig = slab_of(a.reg.dsig, kHead);
    for (int i = threadIdx.x; i < kRows * kHead; i += kThreads) {
      const int r = i / kHead, j = i % kHead;
      float v = 0.0f, sv = 0.0f;
      if (j < 3) {
        const float sg = s.rgb[r][j];
        v = bf(__float2bfloat16_rn(__fmul_rn(
            __fmul_rn(a.g_rgb[(row0 + r) * 3 + j], sg),
            __fsub_rn(1.0f, sg))));
        s.d_raw[r][j] = v;
      }
      if (j == 0) sv = bf(__float2bfloat16_rn(s.gs[r]));
      draw[(size_t)r * kHead + j] = __float2bfloat16_rn(v);
      dsig[(size_t)r * kHead + j] = __float2bfloat16_rn(sv);
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      const int j = threadIdx.x;
      float t = 0.0f;
      for (int r = 0; r < kRows; ++r) t += j < 3 ? s.d_raw[r][j] : s.gs[r];
      bsum[j < 3 ? lay.b_rgb + j : lay.b_sig] = t;
    }
    // ---- view layer: d_h2pre = [h2 > 0]·(d_raw·W_rgbᵀ), in place of h2;
    // its per-ray sums are the cotangent of the per-ray view term
    const long q0 = row0 / a.spr;
    float* dsl = a.dpart + (long)slab * a.M * half;
    bf16* dh2 = slab_of(a.reg.dh2, half);
    for (int c = threadIdx.x; c < half; c += kThreads) {
      const float w0 = bf(wr[c * 3 + 0]), w1 = bf(wr[c * 3 + 1]),
                  w2 = bf(wr[c * 3 + 2]);
      float tot = 0.0f, ray = 0.0f;
      long q = q0;
      for (int r = 0; r < kRows; ++r) {
        const long qr = (row0 + r) / a.spr;
        if (qr != q) {
          dsl[(q - q0) * half + c] = ray;
          ray = 0.0f;
          q = qr;
        }
        float v = fmaf(s.d_raw[r][2], w2,
                       fmaf(s.d_raw[r][1], w1, s.d_raw[r][0] * w0));
        if (!(bf(H2[r * kLdH + c]) > 0.0f)) v = 0.0f;
        tot += v;
        ray += v;
        const bf16 vb = __float2bfloat16_rn(v);
        H2[r * kLdH + c] = vb;
        dh2[(size_t)r * half + c] = vb;
      }
      dsl[(q - q0) * half + c] = ray;
      for (long j = q - q0 + 1; j < a.M; ++j) dsl[j * half + c] = 0.0f;
      bsum[lay.b_view + c] = tot;
    }
    __syncthreads();
    // ---- feature layer: d_feat = bf16(d_h2pre·W_viewᵀ), into Fe
    mma_one<true>(H2, kLdH, half, a.w + lay.w_view, half, W,
                   [&](int r, int c, float v) {
                     const bf16 vb = __float2bfloat16_rn(v);
                     Fe[r * kLdH + c] = vb;
                     return bf(vb);
                   },
                   [&](int c, float t) { bsum[lay.b_feat + c] = t; });
    __syncthreads();
    store_slab(Fe, kLdH, slab_of(a.reg.dfeat, W), W);
    // ---- last trunk layer: d_h = d_feat·W_featᵀ + bf16(g_σ)·w_σ, masked
    const bf16* hl = slab_of(a.reg.h[D - 1], W);
    const bf16* wsig = a.w + lay.w_sig;
    bf16* P = s.h[cur];
    mma_one<true>(Fe, kLdH, W, a.w + lay.w_feat, W, W,
                   [&](int r, int c, float v) {
                     v = __fadd_rn(v, __fmul_rn(
                         bf(__float2bfloat16_rn(s.gs[r])), bf(wsig[c])));
                     if (!(bf(hl[(size_t)r * W + c]) > 0.0f)) v = 0.0f;
                     P[r * kLdH + c] = __float2bfloat16_rn(v);
                     return v;
                   },
                   [&](int c, float t) { bsum[lay.b[D - 1] + c] = t; });
    __syncthreads();
  } else {
    // ---- one 4-wide head: lanes 0-2 sigmoid rgb, lane 3 identity σ
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bf16* wo = a.w + lay.w_out;
    const bf16* Hl = s.h[cur];
    for (int r = warp; r < kRows; r += kWarps) {
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int k = lane; k < W; k += 32) {
        const float hv = bf(Hl[r * kLdH + k]);
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[j] = fmaf(hv, bf(wo[k * 4 + j]),
                                                  acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[j] = warp_sum(acc[j]);
      if (lane == 0)
        for (int j = 0; j < 3; ++j)
          s.rgb[r][j] = sigmoidf(acc[j] + a.b[lay.b_out + j]);
    }
    __syncthreads();
    bf16* draw = slab_of(a.reg.draw, kHead);
    for (int i = threadIdx.x; i < kRows * kHead; i += kThreads) {
      const int r = i / kHead, j = i % kHead;
      float v = 0.0f;
      if (j < 3) {
        const float sg = s.rgb[r][j];
        v = __fmul_rn(__fmul_rn(a.g_rgb[(row0 + r) * 3 + j], sg),
                      __fsub_rn(1.0f, sg));
      } else if (j == 3) {
        v = s.gs[r];
      }
      v = bf(__float2bfloat16_rn(v));
      if (j < 4) s.d_raw[r][j] = v;
      draw[(size_t)r * kHead + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      float t = 0.0f;
      for (int r = 0; r < kRows; ++r) t += s.d_raw[r][threadIdx.x];
      bsum[lay.b_out + threadIdx.x] = t;
    }
    // d_h = d_raw·W_outᵀ (K = 4, by hand), masked by h_{D-1} > 0, written
    // in place of h_{D-1}
    bf16* P = s.h[cur];
    for (int c = threadIdx.x; c < W; c += kThreads) {
      const float w0 = bf(wo[c * 4 + 0]), w1 = bf(wo[c * 4 + 1]),
                  w2 = bf(wo[c * 4 + 2]), w3 = bf(wo[c * 4 + 3]);
      float tot = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        float v = fmaf(s.d_raw[r][3], w3,
                       fmaf(s.d_raw[r][2], w2,
                            fmaf(s.d_raw[r][1], w1, s.d_raw[r][0] * w0)));
        if (!(bf(P[r * kLdH + c]) > 0.0f)) v = 0.0f;
        tot += v;
        P[r * kLdH + c] = __float2bfloat16_rn(v);
      }
      bsum[lay.b[D - 1] + c] = tot;
    }
    __syncthreads();
  }

  // ---- trunk backward. s.h[cur] holds bf16(d_pre) of layer D-1.
  for (int i = D - 1; i >= 0; --i) {
    bf16* P = s.h[cur];
    store_slab(P, kLdH, slab_of(a.reg.dpre[i], W), W);
    if (lay.w_a0[i] >= 0) {
      float* da0 = s.d_a0;
      mma_one<true>(P, kLdH, W, a.w + lay.w_a0[i], W, lay.k0,
                     [&](int r, int c, float v) {
                       da0[r * kMaxK0 + c] += v;
                       return 0.0f;
                     }, no_sum);
    }
    if (lay.w_h[i] >= 0) {
      bf16* Pn = s.h[cur ^ 1];
      const bf16* hp = slab_of(a.reg.h[i - 1], W);
      mma_one<true>(P, kLdH, W, a.w + lay.w_h[i], W, W,
                     [&](int r, int c, float v) {
                       if (!(bf(hp[(size_t)r * W + c]) > 0.0f)) v = 0.0f;
                       Pn[r * kLdH + c] = __float2bfloat16_rn(v);
                       return v;
                     },
                     [&](int c, float t) { bsum[lay.b[i - 1] + c] = t; });
      cur ^= 1;
    }
    __syncthreads();
  }

  // ---- posenc backward: d_x = d_a0[x] + Σ_b d_a0[sin/cos]·cos(P)·2^(b mod L)
  for (int i = threadIdx.x; i < kRows * 3; i += kThreads) {
    const int r = i / 3, j = i % 3;
    const float x = a.pts[(row0 + r) * 3 + j];
    float t = 0.0f;
    for (int blk = 0; blk < 2 * a.L; ++blk) {
      const float f = (float)(1 << (blk % a.L));
      const float off = blk >= a.L ? kHalfPi : 0.0f;
      const float P = __fadd_rn(__fmul_rn(x, f), off);
      t = __fadd_rn(t, __fmul_rn(__fmul_rn(s.d_a0[r * kMaxK0 + 3 + 3 * blk +
                                                  j], cosf(P)), f));
    }
    a.d_pts[(row0 + r) * 3 + j] = __fadd_rn(t, s.d_a0[r * kMaxK0 + j]);
  }
}

// One weight gradient A^T·D: A (rows x a_w) and D (rows x d_w) workspace
// regions; the output block (a_w x out_cols, row-major) sits at out_off of
// the flat gradient. Columns d_w > out_cols are zero padding.
struct Prod {
  long a_col, d_col;
  int a_w, d_w, out_off, out_cols, tiles_n, tile0;
};

struct WgradArgs {
  const bf16* ws;
  long rows;             // rows of the pass (region height)
  long rows_per_split;
  float* part;           // (n_split, n_w)
  long n_w;
  int n_prod;
  Prod p[kMaxProds];
};

__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradArgs a) {
  __shared__ __align__(128) bf16 As[kWRows][kWTile + 8];
  __shared__ __align__(128) bf16 Ds[kWRows][kWTile + 8];
  __shared__ __align__(128) float out[kWarps][2][256];
  int pi = 0;
  while (pi + 1 < a.n_prod && a.p[pi + 1].tile0 <= (int)blockIdx.x) ++pi;
  const Prod& p = a.p[pi];
  const int lt = blockIdx.x - p.tile0;
  const int m0 = (lt / p.tiles_n) * kWTile, n0 = (lt % p.tiles_n) * kWTile;
  const long r_begin = (long)blockIdx.y * a.rows_per_split;
  const long r_end = r_begin + a.rows_per_split < a.rows
                         ? r_begin + a.rows_per_split : a.rows;
  const bf16* A = a.ws + p.a_col * a.rows;
  const bf16* Dm = a.ws + p.d_col * a.rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;   // 4 x 2 warps, 16 x 32 each
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  const int rr = threadIdx.x >> 3, vv = threadIdx.x & 7;   // 32 rows x 8 vec
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (long r = r_begin; r < r_end; r += kWRows) {
    const int ca = m0 + vv * 8, cd = n0 + vv * 8;
    *reinterpret_cast<uint4*>(&As[rr][vv * 8]) =
        ca < p.a_w ? *reinterpret_cast<const uint4*>(
                         A + (r + rr) * p.a_w + ca) : zero;
    *reinterpret_cast<uint4*>(&Ds[rr][vv * 8]) =
        cd < p.d_w ? *reinterpret_cast<const uint4*>(
                         Dm + (r + rr) * p.d_w + cd) : zero;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWRows; kk += 16) {
      // A^T tile: element (m, k) = As[k][m], i.e. column-major
      wmma::load_matrix_sync(fa, &As[kk][wm * 16], kWTile + 8);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::load_matrix_sync(fb, &Ds[kk][wn * 32 + f * 16], kWTile + 8);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
    __syncthreads();
  }
  float* dst = a.part + (long)blockIdx.y * a.n_w + p.out_off;
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(out[warp][f], acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = m0 + wm * 16 + (e >> 4);
      const int col = n0 + wn * 32 + f * 16 + (e & 15);
      if (row < p.a_w && col < p.out_cols)
        dst[(long)row * p.out_cols + col] = out[warp][f][e];
    }
  }
}

// out[i] = (accumulate ? out[i] : 0) + Σ_p part[p][i], p in order.
__global__ void sum_rows_kernel(const float* part, int n_part, long m,
                                float* out, int accumulate) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float t = accumulate ? out[i] : 0.0f;
  for (int p = 0; p < n_part; ++p) t += part[(long)p * m + i];
  out[i] = t;
}

// d_dir[q][c] = Σ over the slabs that hold ray q of their partial, in slab
// order.
__global__ void dir_sum_kernel(const float* dpart, float* d_dir, long n_rays,
                               int spr, int M, int half) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays * half) return;
  const long q = i / half;
  const int c = i % half;
  const long s_lo = q * spr / kRows, s_hi = ((q + 1) * spr - 1) / kRows;
  float t = 0.0f;
  for (long sl = s_lo; sl <= s_hi; ++sl) {
    const long j = q - sl * kRows / spr;
    t += dpart[(sl * M + j) * half + c];
  }
  d_dir[i] = t;
}

}  // namespace fnt

extern "C" {

// n must be a multiple of 64 and of spr, chunk a multiple of 64.
// Returns a cudaError_t.
int fnt_field_backward(const void* pts, const void* dirpart, const void* w,
                       const void* b, const void* g_rgb, const void* g_sigma,
                       void* d_pts, void* d_dir, void* d_w, void* d_b,
                       void* ws, void* wpart, void* bpart, void* dpart,
                       long ws_numel, int n, int spr, int L, int depth,
                       int width, int k0, int skip, int has_vd, int chunk,
                       int n_split, int M, void* stream) {
  using namespace fnt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout lay = make_layout(depth, width, k0, skip, has_vd);
  const Regions reg = make_regions(lay);
  if (layout_error(lay) || n % kRows || chunk % kRows || chunk < kRows ||
      spr < 1 || n % spr || 3 + 6 * L > k0 || n_split < 1 || M < 1 ||
      (long)chunk * reg.cols > ws_numel)
    return (int)cudaErrorInvalidValue;
  const int half = width / 2;
  int n_w = 0, n_b = 0;
  {
    // the flat sizes: the layout's last offsets plus the last blocks
    if (has_vd) { n_w = lay.w_rgb + half * 3; n_b = lay.b_rgb + 3; }
    else { n_w = lay.w_out + width * 4; n_b = lay.b_out + 4; }
  }
  // the weight-gradient products, in layout order
  WgradArgs wa{};
  int np = 0, tiles = 0;
  auto add = [&](long a_col, int a_w, long d_col, int d_w, int out_off,
                 int out_cols) {
    Prod& p = wa.p[np++];
    p.a_col = a_col; p.a_w = a_w; p.d_col = d_col; p.d_w = d_w;
    p.out_off = out_off; p.out_cols = out_cols;
    p.tiles_n = (out_cols + kWTile - 1) / kWTile;
    p.tile0 = tiles;
    tiles += ((a_w + kWTile - 1) / kWTile) * p.tiles_n;
  };
  for (int i = 0; i < depth; ++i) {
    if (lay.w_h[i] >= 0)
      add(reg.h[i - 1], width, reg.dpre[i], width, lay.w_h[i], width);
    if (lay.w_a0[i] >= 0)
      add(reg.a0, k0, reg.dpre[i], width, lay.w_a0[i], width);
  }
  if (has_vd) {
    add(reg.h[depth - 1], width, reg.dsig, kHead, lay.w_sig, 1);
    add(reg.h[depth - 1], width, reg.dfeat, width, lay.w_feat, width);
    add(reg.feat, width, reg.dh2, half, lay.w_view, half);
    add(reg.h2, half, reg.draw, kHead, lay.w_rgb, 3);
  } else {
    add(reg.h[depth - 1], width, reg.draw, kHead, lay.w_out, 4);
  }
  wa.n_prod = np;
  wa.ws = static_cast<const bf16*>(ws);
  wa.part = static_cast<float*>(wpart);
  wa.n_w = n_w;

  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(BwdSmem));
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;

  RowsArgs ra;
  ra.pts = static_cast<const float*>(pts);
  ra.dirpart = static_cast<const bf16*>(dirpart);
  ra.w = static_cast<const bf16*>(w);
  ra.b = static_cast<const float*>(b);
  ra.g_rgb = static_cast<const float*>(g_rgb);
  ra.g_sigma = static_cast<const float*>(g_sigma);
  ra.d_pts = static_cast<float*>(d_pts);
  ra.dpart = static_cast<float*>(dpart);
  ra.bpart = static_cast<float*>(bpart);
  ra.ws = static_cast<bf16*>(ws);
  ra.spr = spr; ra.L = L; ra.M = M; ra.n_b = n_b;
  ra.lay = lay;
  ra.reg = reg;
  for (long r0 = 0; r0 < n; r0 += chunk) {
    const long rows = n - r0 < chunk ? n - r0 : chunk;
    const int slabs = (int)(rows / kRows);
    ra.rows = rows;
    ra.slab0 = (int)(r0 / kRows);
    bwd_rows_kernel<<<slabs, kThreads, sizeof(BwdSmem), st>>>(ra);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    wa.rows = rows;
    wa.rows_per_split = ((rows + n_split - 1) / n_split + kWRows - 1) /
                        kWRows * kWRows;
    wgrad_kernel<<<dim3(tiles, n_split), kThreads, 0, st>>>(wa);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int acc = r0 > 0;
    sum_rows_kernel<<<(n_w + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(wpart), n_split, n_w,
        static_cast<float*>(d_w), acc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sum_rows_kernel<<<(n_b + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(bpart), slabs, n_b,
        static_cast<float*>(d_b), acc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (has_vd) {
    const long n_rays = n / spr;
    dir_sum_kernel<<<(int)((n_rays * half + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(dpart), static_cast<float*>(d_dir), n_rays,
        spr, M, half);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
