// Fused posenc + NeRF-MLP field, backward (kernel K4).
//
// Replaces: src/fashion_nerf/kernels/posenc_mlp_pallas.py::_field_bwd_kernel
// (via _fused_bwd_eval / _pallas_backward), the TPU kernel that recomputes
// the forward of a 512-row tile in VMEM, backprops it, and accumulates the
// weight gradients across its sequential grid into one VMEM output.
//
// What bounds it on the H100: bf16 matrix products, three times the
// forward's (recompute, dgrad, wgrad: ~3.5 MFLOP per row of the 8x256
// field, 2.8 ms at 786,432 rows); and in this design the bytes of the bf16
// workspace below (9,920 bytes a row at 8×256, written once and read at
// least once: ~4.7 ms at 786,432 rows and 3.35 TB/s), which is the higher
// floor.
//
// Design. Blocks run in parallel and in no order, so the TPU's carried wgrad
// sum has no counterpart; and a block's shared memory cannot hold a
// 64-row slab's eight trunk activations next to its working buffers. So K4
// is four kernels, launched per pass of up to `chunk` rows:
//  1. bwd_rows_kernel: persistent blocks of two consumer warpgroups and one
//     producer warpgroup, 128 rows an item, as K3 (field.cu). The forward
//     recompute is K3's wgmma layer loop (wg_field.cuh); every layer's bf16
//     output tile goes to the workspace as it lies in shared memory, by one
//     bulk store (cp.async.bulk), and its relu bits, one word per thread
//     and 32 columns, to a small buffer in device memory (`masks`), which
//     the dgrad epilogues read back.
//     The dgrad products dZ·Wᵀ run on wgmma too, with the weights'
//     transposes packed as slices of their own
//     (kernels/wgpack.py::field_slices_t) and streamed through the same ring
//     after the forward's: the weights are packed on every call anyway, and
//     packed transposes keep B in the K-major layout the forward uses. Each
//     bf16-rounded pre-activation cotangent is the next A operand in
//     shared memory and goes to the workspace for wgrad. The heads are
//     register dot products; the posenc backward takes the f32 sum of the
//     posenc cotangents of every layer that takes the operand (the skip
//     layers' sum waits in device memory, added to in the backward's layer
//     order, last layer first, as the plain version sums them) through the
//     phases' f32 cosines once, one thread per (row, coordinate) over a
//     shared-memory copy of it. Bias-gradient
//     column sums and per-ray view-term sums are written as per-64-row-slab
//     partials.
//  2. wgrad_kernel: every weight gradient Aᵀ·D over the pass's rows, with
//     rows as the K dimension, on wgmma: a 128 × N output tile per block
//     (N = the cotangent's width: 256, 128, 64 or 16), two consumer
//     warpgroups of m64nN, and a fixed split of the rows per blockIdx.y
//     into per-split partials. The operands are the workspace's 64-row
//     blocks, brought in by bulk copies, in the rows kernel's core-matrix
//     layout, which with rows as K is MN-major: the wgmma transpose bits
//     read them as they are.
//  3. sum_rows_kernel: the partials summed in a fixed order into the
//     outputs (weights over splits, biases over slabs), added to what the
//     earlier passes left there.
//  4. After the last pass, dir_sum_kernel sums each ray's slab partials.
// No float atomics anywhere: the same inputs give bitwise the same
// gradients, so a resumed run retraces its trajectory.
//
// What the rows kernel's time goes to (8×256, 786,432 rows; PERF.md §5):
// not the tensor cores, whose wgmmas account for ~1.1 of ~8.5 ms, but the
// workspace stores, ~2.8 ms with L2's default policy though the wait for
// them costs nothing: so the bulk stores mark their lines evict_first
// (wg_field.cuh::bulk_store), which took ~2 ms off. The weight ring has 4
// slots (the biases are read from device memory to make room for the
// fourth). The two consumer warpgroups issue in lockstep: on a ping-pong
// schedule (one warpgroup's epilogue under the other's wgmmas, turns handed
// over by named barriers) the kernel ran 10-16% slower at W = 256 and no
// faster at W = 128. A turn's slices stay in the ring until the other
// warpgroup has issued them too, so the producer has fewer free slots, and
// the wgmmas were a small part of the time to hide. What bounds it now
// (~6.6 ms): the epilogues, then the stores' remaining ~1 ms, the
// wgmmas' ~0.9 and the ring's ~0.7, each the time it saves when removed.
//
// The conditioned plan (the reference's `dcond` output): with a non-null
// condpart (n / spr, cw) bf16, the per-ray cond @ cond_kernel, the rows
// kernel is instantiated with K3's cond window (wgf::forward<W, true>), so
// the recompute adds each ray's slices to the accumulators of trunk_0 and
// of every skip layer before the bias. The cond enters additively, so its
// cotangent is those layers' unrounded f32 pre-activation cotangent: where
// the epilogue that makes it runs (the heads' for the last trunk layer, the
// next layer's dgrad otherwise), the f32 values go through the warpgroup's
// free activation tile H, half the columns at a time, and a thread per
// column sums each ray's rows in row order into per-64-row-slab partials
// (n / 64, M, cw), as the view term's. After the last pass, dir_sum_kernel
// sums each ray's partials in slab order into d_cond (n / spr, cw). The
// reference halves its backward tile for conditioned plans to fit VMEM;
// here the condpart is read from device memory in the epilogue, as K3
// reads it, and nothing else changes shape.
//
// Rounding points follow the reference (posenc_mlp_pallas.py:724-801):
// cotangents of pre-activations are rounded to bf16 as the operands of both
// products, accumulation is f32, bias gradients are f32 sums of the
// unrounded cotangents (of the rounded ones for the rgb head, the feature
// layer and the no-view-branch head, as the reference sums those after
// rounding), sin/cos are f32.
#include "wg_field.cuh"

namespace fnt {

constexpr int kMaxProds = 2 * kMaxDepth + 4;
constexpr int kHead = 16;        // padded width of the head cotangents
constexpr int kStagesK4 = 4;     // weight ring slices of the rows kernel
constexpr int kWgStages = 4;     // operand ring stages of wgrad

// Column offsets of the workspace regions (each region is `rows` x width,
// in 64-row blocks, each in the core-matrix layout of a shared-memory tile:
// element (r, c) at wg::cm_off(r, c, width) bytes). Must equal
// kernels/posenc_mlp.py::bwd_workspace_cols.
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

namespace {

template <int W>
struct __align__(128) BwdSmem {
  bf16 h[2][wg::kWgRows * W];        // activations, then cotangents
  bf16 a0[2][wg::kWgRows * kMaxK0];  // posenc operand, then column sums
  wgf::Ring<kStagesK4> ring;
  bf16 dirs[2][wgf::kMaxRays][W / 2];
  float pts[2][wg::kWgRows][3];
  float grgb[2][wg::kWgRows][3];     // rgb cotangents
  float gs[2][wg::kWgRows];          // σ cotangents
  float draw[2][wg::kWgRows][4];     // bf16-valued head cotangents
  float dpts[2][wg::kWgRows][3];     // position cotangents
  float heads[W * 4];
  float row_sigma[wg::kItemRows];
  float row_rgb[wg::kItemRows][3];
};
// The fourth slot of the ring fits at W = 256 because the biases (up to
// 9.7 KB) are read from device memory, through L1, and not copied here.
static_assert(sizeof(BwdSmem<256>) <= 227 * 1024,
              "the rows kernel's shared memory");

struct RowsArgs {
  const float* pts;      // (n, 3)
  const bf16* dirpart;   // (n / spr, width / 2)
  const bf16* w;         // packed weights (Layout): the heads
  const bf16* wp;        // field slices, then their transposes (wgpack.py)
  const float* b;
  const float* g_rgb;    // (n, 3)
  const float* g_sigma;  // (n,)
  float* d_pts;          // (n, 3)
  float* dpart;          // (n / 64, M, width / 2) per-slab ray sums
  const bf16* condpart;  // (n / spr, cw) per-ray cond term, or null
  float* cpart;          // (n / 64, M, cw) per-slab ray sums of its cotangent
  float* bpart;          // (chunk / 64, n_b) per-slab bias sums
  bf16* ws;              // workspace, regions of `rows` rows
  float* a0s;            // (chunk / 64, k0 / 2, 128) the skip layers'
                         // posenc cotangents summed, per thread of a
                         // warpgroup
  uint32_t* masks;       // (chunk / 64 + 1, depth, W / 64, 128) relu bits of
                         // the trunk layers, per thread (the last slab is
                         // a warpgroup without rows)
  long rows;             // rows of the pass (region height)
  long r0;               // first row of the pass
  int spr, L, M, n_b;
  int cw;                // condpart columns (n_cond·W), 0 without one
  int last_skip;         // the highest skip layer, 0 without one: the
                         // first whose posenc cotangent the backward meets
  int n_slices;
  int slice_bytes[wgf::kMaxSlices];
  Layout lay;
  Regions reg;
};

// One stage of colsum_pair's butterfly: lanes 2M apart swap halves of
// p[0, 2M), each keeping the sums of one half in p[0, M) (lane bit 4, 3 or
// 2 set: the upper half).
template <int M>
__device__ __forceinline__ void colsum_stage(float (&p)[16], int lane,
                                             int& base) {
  const int up = lane & (2 * M);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float send = up ? p[k] : p[k + M];
    p[k] = (up ? p[k + M] : p[k]) + __shfl_xor_sync(0xffffffffu, send, 2 * M);
  }
  base += up ? M : 0;
}

// Column sums of the warpgroup's 64 rows, in a fixed order: the thread's
// two rows (s0, s1: columns 8j + cA and + 1 of the epilogue's step j), the
// 8 row groups of a warp, then the 4 warps in order (colsum_out). The
// warp's sums run on 8 steps at once (p): a transposing butterfly over
// lanes xor 16, 8, 4 halves the values a lane holds at each stage, so 14
// shuffles leave each lane the sums of 2 of the 64 columns.
__device__ __forceinline__ void colsum_pair(float* cs, int N, int ww,
                                            int lane, int cA, int j,
                                            float (&p)[16], float s0,
                                            float s1) {
  p[2 * (j & 7)] = s0;
  p[2 * (j & 7) + 1] = s1;
  if ((j & 7) != 7) return;
  int base = 0;
  colsum_stage<8>(p, lane, base);
  colsum_stage<4>(p, lane, base);
  colsum_stage<2>(p, lane, base);
  const int c = 8 * ((j & ~7) + base / 2) + cA;
  cs[ww * N + c] = p[0];
  cs[ww * N + c + 1] = p[1];
}

__device__ __forceinline__ void colsum_out(const float* cs, int N, int tw,
                                           float* dst, bool live) {
  for (int c = tw; c < N; c += 128)
    if (live) dst[c] = ((cs[c] + cs[N + c]) + cs[2 * N + c]) + cs[3 * N + c];
}

// The posenc backward: acc = d_a0, the posenc operand's cotangent, on the
// thread's accumulator positions (K0 columns). It goes row-major through
// the f32 scratch S (64 × K0, free shared memory) so that each of the
// 64 × 3 (row, coordinate) pairs is one thread's short loop over its
// phases: d_x = d_a0[x] + Σ_b d_a0[sin/cos b]·cos(P_b)·2^(b mod L), to
// dpts. The warpgroup must be done with S before the call and sync after.
template <int K0>
__device__ __forceinline__ void posenc_bwd(const float (&acc)[K0 / 2],
                                           float* S, const float (*pts)[3],
                                           float (*dpts)[3], int L, int rA,
                                           int cA, int tw, int bar) {
#pragma unroll
  for (int j = 0; j < K0 / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(S + (rA + 8 * h) * K0 + 8 * j + cA) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  wg::wg_sync(bar);
  for (int t = tw; t < 64 * 3; t += 128) {
    const int r = t / 3, q = t % 3;
    const float* d = S + r * K0 + 3 + q;
    const float x = pts[r][q];
    float dx = S[r * K0 + q];
    for (int half = 0; half < 2; ++half) {
      const float off = half ? kHalfPi : 0.0f;
      float f = 1.0f;
      for (int k = 0; k < L; ++k, f *= 2.0f, d += 3) {
        const float P = __fadd_rn(__fmul_rn(x, f), off);
        dx = __fadd_rn(dx, __fmul_rn(__fmul_rn(*d, cosf(P)), f));
      }
    }
    dpts[r][q] = dx;
  }
}

template <int W, bool kCond>
__global__ void __launch_bounds__(wgf::kThreads, 1)
    bwd_rows_kernel(const __grid_constant__ RowsArgs a) {
  constexpr int kHalf = W / 2, kWords = W / 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem<W>& s = *reinterpret_cast<BwdSmem<W>*>(smem_raw);
  const Layout& lay = a.lay;
  const Regions& reg = a.reg;
  const int D = lay.depth, k0 = lay.k0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) wgf::ring_init(s.ring);
  if (lay.has_vd) {
    for (int i = threadIdx.x; i < W; i += blockDim.x)
      s.heads[i] = bf(a.w[lay.w_sig + i]);
    for (int i = threadIdx.x; i < kHalf * 3; i += blockDim.x)
      s.heads[W + i] = bf(a.w[lay.w_rgb + i]);
  } else {
    for (int i = threadIdx.x; i < W * 4; i += blockDim.x)
      s.heads[i] = bf(a.w[lay.w_out + i]);
  }
  __syncthreads();
  const int n_items = (int)((a.rows + wg::kItemRows - 1) / wg::kItemRows);

  if (warp >= wgf::kConsumers / 32) {
    wg::setmaxnreg_dec<40>();
    if (warp == wgf::kConsumers / 32 && lane == 0)
      wgf::produce(s.ring, a.wp, a.slice_bytes, a.n_slices, n_items);
    return;
  }

  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, tw = threadIdx.x & 127, ww = tw >> 5;
  bf16* H = s.h[g];
  const uint32_t h_addr = wg::smem_addr(H);
  float(*pts)[3] = s.pts[g];
  float(*grgb)[3] = s.grgb[g];
  float* gs = s.gs[g];
  float(*draw)[4] = s.draw[g];
  float(*dpts)[3] = s.dpts[g];
  bf16(*dirs)[kHalf] = s.dirs[g];
  float* cs = reinterpret_cast<float*>(s.a0[g]);   // 4 × W column sums
  float* row_sigma = s.row_sigma + 64 * g;
  float(*row_rgb)[3] = s.row_rgb + 64 * g;
  wgf::Rows t{H, s.a0[g], a.b, s.heads, pts, nullptr, nullptr, row_sigma,
              row_rgb, nullptr, tw, ww, lane, 1 + g, 16 * ww + (lane >> 2),
              2 * (lane & 3)};
  const int rA = t.rA, cA = t.cA, bar = t.bar;
  // A final tile (64 rows × cols in the core-matrix layout) goes to its
  // workspace block as it is, by one bulk store that one thread issues;
  // guard() waits until the stores have read their tiles, before a tile (H
  // or A0) is overwritten, and precedes a warpgroup barrier.
  bool pending = false;
  auto guard = [&]() {
    if (pending && tw == 0) wgf::bulk_wait_read<0>();
    pending = false;
  };
  auto store = [&](const bf16* tile, int cols, bf16* dst) {
    if (tw == 0) {
      wgf::bulk_store(dst, tile, cols * 64 * 2);
      wgf::bulk_commit();
    }
    pending = true;
  };
  wgf::RingPos rp{0, 0u, -1};
  float acc[W / 2];
  float csp[16];   // column-sum partials of 8 epilogue steps (colsum_pair)

  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const long lrow0 = (long)it * wg::kItemRows + 64 * g;   // in the pass
    const bool live = lrow0 < a.rows;
    const long row0 = a.r0 + lrow0;                        // global
    const long ls = lrow0 / 64;                            // slab in pass
    // the slab's block of the region at column offset col (width columns)
    auto blk = [&](long col, int width) {
      return a.ws + col * a.rows + ls * width * 64;
    };
    float* bsum = a.bpart + ls * a.n_b;
    uint32_t* mask = a.masks + ls * D * kWords * 128;
    t.mask = mask;
    for (int i = tw; i < 64 * 3; i += 128) {
      pts[i / 3][i % 3] = live ? a.pts[row0 * 3 + i] : 0.0f;
      grgb[i / 3][i % 3] = live ? a.g_rgb[row0 * 3 + i] : 0.0f;
    }
    if (tw < 64) gs[tw] = live ? a.g_sigma[row0 + tw] : 0.0f;
    const long ray0 = row0 / a.spr;
    const int nr = (int)((row0 + 63) / a.spr - ray0 + 1);
    const bool staged = nr <= wgf::kMaxRays;
    if (lay.has_vd && live && staged)
      for (int i = tw; i < nr * kHalf; i += 128)
        dirs[i / kHalf][i % kHalf] = a.dirpart[ray0 * kHalf + i];
    t.dir_lo = t.dir_hi = dirs[0];
    if (lay.has_vd && live) {
      const long q_lo = (row0 + rA) / a.spr, q_hi = (row0 + rA + 8) / a.spr;
      t.dir_lo = staged ? dirs[q_lo - ray0] : a.dirpart + q_lo * kHalf;
      t.dir_hi = staged ? dirs[q_hi - ray0] : a.dirpart + q_hi * kHalf;
    }
    if (kCond) {
      // a warpgroup without rows reads ray 0's (its outputs are dropped)
      const long q_lo = live ? (row0 + rA) / a.spr : 0;
      const long q_hi = live ? (row0 + rA + 8) / a.spr : 0;
      t.cond_lo = a.condpart + q_lo * a.cw;
      t.cond_hi = a.condpart + q_hi * a.cw;
    }
    guard();
    wg::wg_sync(bar);
    wgf::posenc_tile(t.A0, k0, a.L, pts, tw);
    wg::fence_async_smem();
    wg::wg_sync(bar);
    if (live) store(t.A0, k0, blk(reg.a0, k0));

    // ---- forward recompute; every output to the workspace
    wgf::forward<W, kCond>(lay, t, s.ring, rp, acc, [&](int kind, int i) {
      if (!live) return;
      if (kind == 0) store(H, W, blk(reg.h[i], W));
      else if (kind == 1) store(H, W, blk(reg.feat, W));
      else store(H, kHalf, blk(reg.h2, kHalf));
    }, guard);

    // ---- head cotangents: d_raw = bf16(g·s·(1−s)) (rgb), bf16(g_σ)
    if (tw < 64) {
      const int r = tw;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float sg = row_rgb[r][q];
        draw[r][q] = bf(__float2bfloat16_rn(__fmul_rn(
            __fmul_rn(grgb[r][q], sg), __fsub_rn(1.0f, sg))));
      }
      draw[r][3] = bf(__float2bfloat16_rn(gs[r]));
      if (live) {
        bf16* dr = blk(reg.draw, kHead);
        bf16* ds = blk(reg.dsig, kHead);
        const int nh = lay.has_vd ? 3 : 4;
        for (int j = 0; j < kHead; ++j) {
          const int e = wg::cm_off(r, j, kHead) / 2;
          dr[e] = __float2bfloat16_rn(j < nh ? draw[r][j] : 0.0f);
          ds[e] = __float2bfloat16_rn(lay.has_vd && j == 0 ? draw[r][3]
                                                           : 0.0f);
        }
      }
    }
    guard();
    wg::wg_sync(bar);
    if (tw < 4 && live) {
      const int j = tw;
      float tot = 0.0f;
      if (lay.has_vd) {
        for (int r = 0; r < 64; ++r) tot += j < 3 ? draw[r][j] : gs[r];
        bsum[j < 3 ? lay.b_rgb + j : lay.b_sig] = tot;
      } else {
        for (int r = 0; r < 64; ++r) tot += draw[r][j];
        bsum[lay.b_out + j] = tot;
      }
    }

    uint32_t mw[kWords];
    auto load_mask = [&](int layer) {
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        mw[w] = mask[(layer * kWords + w) * 128 + tw];
    };
    auto on = [&](int j, int q) {
      return (mw[j / 8] >> (4 * (j % 8) + q)) & 1u;
    };
    // The per-ray sums of a cond layer's unrounded pre-activation cotangent
    // over the slab, as its partials: vals(j, v) gives the thread's four
    // values of epilogue step j (rows rA, rA + 8; columns c, c + 1). H must
    // be free; it holds the values as f32 (64 × W/2), half the columns at
    // a time, and a thread per column sums each ray's rows in row order.
    // Leaves H free.
    auto cond_partials = [&](int layer, auto vals) {
      if (!kCond || lay.w_a0[layer] < 0) return;
      int ci = 0;   // the layer's cond slice: x-layers below it
      for (int i = 0; i < layer; ++i) ci += lay.w_a0[i] >= 0;
      float* S = reinterpret_cast<float*>(H);
      float* dst = a.cpart + (row0 / 64) * a.M * a.cw + ci * W;
      const long q0 = row0 / a.spr;
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
#pragma unroll
        for (int jj = 0; jj < W / 16; ++jj) {
          const int j = hc * (W / 16) + jj;
          const int c = 8 * jj + cA;
          float v[4];
          vals(j, v);
          *reinterpret_cast<float2*>(S + rA * kHalf + c) =
              make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(S + (rA + 8) * kHalf + c) =
              make_float2(v[2], v[3]);
        }
        wg::wg_sync(bar);
        for (int c = tw; c < kHalf; c += 128) {
          float* col = dst + hc * kHalf + c;
          float ray = 0.0f;
          long q = q0;
          int in_ray = (int)(row0 - q0 * a.spr);   // row's place in its ray
          for (int r = 0; r < 64; ++r, ++in_ray) {
            if (in_ray == a.spr) {
              if (live) col[(q - q0) * a.cw] = ray;
              ray = 0.0f;
              ++q;
              in_ray = 0;
            }
            ray += S[r * kHalf + c];
          }
          if (live) {
            col[(q - q0) * a.cw] = ray;
            for (long m = q - q0 + 1; m < a.M; ++m) col[m * a.cw] = 0.0f;
          }
        }
        wg::wg_sync(bar);
      }
    };

    if (lay.has_vd) {
      // ---- view layer: d_h2pre = [h2 > 0]·(d_raw·W_rgbᵀ), in place of
      // h2 (a column a thread); its per-ray sums are the cotangent of the
      // per-ray view term
      const long q0 = row0 / a.spr;
      float* dsl = a.dpart + (row0 / 64) * a.M * kHalf;
      for (int c = tw; c < kHalf; c += 128) {
        const float* wr = s.heads + W + c * 3;
        const float w0 = wr[0], w1 = wr[1], w2 = wr[2];
        float tot = 0.0f, ray = 0.0f;
        long q = q0;
        int in_ray = (int)(row0 - q0 * a.spr);   // row's place in its ray
        for (int r = 0; r < 64; ++r, ++in_ray) {
          if (in_ray == a.spr) {
            if (live) dsl[(q - q0) * kHalf + c] = ray;
            ray = 0.0f;
            ++q;
            in_ray = 0;
          }
          float v = fmaf(draw[r][2], w2, fmaf(draw[r][1], w1, draw[r][0] * w0));
          bf16* e = reinterpret_cast<bf16*>(reinterpret_cast<char*>(H) +
                                            wg::cm_off(r, c, kHalf));
          if (!(bf(*e) > 0.0f)) v = 0.0f;
          tot += v;
          ray += v;
          *e = __float2bfloat16_rn(v);
        }
        if (live) {
          dsl[(q - q0) * kHalf + c] = ray;
          for (long j = q - q0 + 1; j < a.M; ++j) dsl[j * kHalf + c] = 0.0f;
          bsum[lay.b_view + c] = tot;
        }
      }
      wg::fence_async_smem();
      wg::wg_sync(bar);
      if (live) store(H, kHalf, blk(reg.dh2, kHalf));

      // ---- feature layer: d_feat = bf16(d_h2pre·W_viewᵀ)
      for (int k = 0; k < kHalf; k += wg::kSliceK)
        wgf::consume<W>(acc, rp, s.ring, h_addr, kHalf, k, wg::kSliceK,
                        k == 0);
      wgf::drain(acc, rp, s.ring);
      guard();
      wg::wg_sync(bar);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int c = 8 * j + cA;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j],
                                                        acc[4 * j + 1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * j + 2],
                                                        acc[4 * j + 3]);
        wgf::st_pair(H, rA, c, W, lo);
        wgf::st_pair(H, rA + 8, c, W, hi);
        colsum_pair(cs, W, ww, lane, cA, j, csp,
                    __low2float(lo) + __low2float(hi),
                    __high2float(lo) + __high2float(hi));
      }
      wg::fence_async_smem();
      wg::wg_sync(bar);
      colsum_out(cs, W, tw, bsum + lay.b_feat, live);
      if (live) store(H, W, blk(reg.dfeat, W));

      // ---- last trunk layer: d_h = d_feat·W_featᵀ + bf16(g_σ)·w_σ, masked
      for (int k = 0; k < W; k += wg::kSliceK)
        wgf::consume<W>(acc, rp, s.ring, h_addr, W, k, wg::kSliceK, k == 0);
      load_mask(D - 1);   // under the wgmmas in flight
      wgf::drain(acc, rp, s.ring);
      guard();
      wg::wg_sync(bar);
      const float g_lo = draw[rA][3], g_hi = draw[rA + 8][3];
      auto last_vals = [&](int j, float (&v)[4]) {
        const int c = 8 * j + cA;
        const float s0 = s.heads[c], s1 = s.heads[c + 1];
        v[0] = __fadd_rn(acc[4 * j], __fmul_rn(g_lo, s0));
        v[1] = __fadd_rn(acc[4 * j + 1], __fmul_rn(g_lo, s1));
        v[2] = __fadd_rn(acc[4 * j + 2], __fmul_rn(g_hi, s0));
        v[3] = __fadd_rn(acc[4 * j + 3], __fmul_rn(g_hi, s1));
#pragma unroll
        for (int q = 0; q < 4; ++q) if (!on(j, q)) v[q] = 0.0f;
      };
      cond_partials(D - 1, last_vals);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int c = 8 * j + cA;
        float v[4];
        last_vals(j, v);
        wgf::st_pair(H, rA, c, W, __floats2bfloat162_rn(v[0], v[1]));
        wgf::st_pair(H, rA + 8, c, W, __floats2bfloat162_rn(v[2], v[3]));
        colsum_pair(cs, W, ww, lane, cA, j, csp, v[0] + v[2],
                    v[1] + v[3]);
      }
    } else {
      // ---- 4-wide head: d_h = d_raw·W_outᵀ (K = 4, by hand), masked
      load_mask(D - 1);
      auto head_vals = [&](int j, float (&v)[4]) {
        const int c = 8 * j + cA;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wo = s.heads + (c + (q & 1)) * 4;
          const float(&d)[4] = draw[rA + 8 * (q >> 1)];
          v[q] = fmaf(d[3], wo[3], fmaf(d[2], wo[2],
                                        fmaf(d[1], wo[1], d[0] * wo[0])));
          if (!on(j, q)) v[q] = 0.0f;
        }
      };
      cond_partials(D - 1, head_vals);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int c = 8 * j + cA;
        float v[4];
        head_vals(j, v);
        wgf::st_pair(H, rA, c, W, __floats2bfloat162_rn(v[0], v[1]));
        wgf::st_pair(H, rA + 8, c, W, __floats2bfloat162_rn(v[2], v[3]));
        colsum_pair(cs, W, ww, lane, cA, j, csp, v[0] + v[2],
                    v[1] + v[3]);
      }
    }
    wg::fence_async_smem();
    wg::wg_sync(bar);
    colsum_out(cs, W, tw, bsum + lay.b[D - 1], live);

    // ---- trunk backward. H holds bf16(d_pre) of layer i. The skip
    // layers' posenc cotangents wait in device memory (per thread) for
    // layer 0's, summed in f32 in the order the plain version sums them
    // (the last skip layer's first, then each lower one's added), and the
    // sum with layer 0's goes through the phases' cosines once.
    float* stash = a.a0s + ls * (k0 / 2) * 128 + tw;
    auto posenc_part = [&](auto& acc_a, int i) {
      constexpr int n = sizeof(acc_a) / sizeof(float);
      if (i > 0) {
        if (live) {
#pragma unroll
          for (int j = 0; j < n; ++j)
            stash[j * 128] = i == a.last_skip
                                 ? acc_a[j]
                                 : __fadd_rn(stash[j * 128], acc_a[j]);
        }
        return;
      }
      if (a.last_skip > 0 && live) {
#pragma unroll
        for (int j = 0; j < n; ++j)
          acc_a[j] = __fadd_rn(stash[j * 128], acc_a[j]);
      }
      guard();             // layer 0's cotangent store has read H
      wg::wg_sync(bar);    // and so have the warpgroup's wgmmas
      posenc_bwd<2 * n>(acc_a, reinterpret_cast<float*>(H), pts, dpts, a.L,
                        rA, cA, tw, bar);
    };
    for (int i = D - 1; i >= 0; --i) {
      if (live) store(H, W, blk(reg.dpre[i], W));
      if (lay.w_a0[i] >= 0) {
        if (k0 == 64) {
          float(&acc_a)[32] = *reinterpret_cast<float(*)[32]>(acc);
          for (int k = 0; k < W; k += wg::kSliceK)
            wgf::consume<64>(acc_a, rp, s.ring, h_addr, W, k, wg::kSliceK,
                             k == 0);
          wgf::drain(acc_a, rp, s.ring);
          posenc_part(acc_a, i);
        } else {
          float(&acc_a)[24] = *reinterpret_cast<float(*)[24]>(acc);
          for (int k = 0; k < W; k += wg::kSliceK)
            wgf::consume<48>(acc_a, rp, s.ring, h_addr, W, k, wg::kSliceK,
                             k == 0);
          wgf::drain(acc_a, rp, s.ring);
          posenc_part(acc_a, i);
        }
      }
      if (lay.w_h[i] >= 0) {
        for (int k = 0; k < W; k += wg::kSliceK)
          wgf::consume<W>(acc, rp, s.ring, h_addr, W, k, wg::kSliceK, k == 0);
        load_mask(i - 1);   // under the wgmmas in flight
        wgf::drain(acc, rp, s.ring);
        guard();
        wg::wg_sync(bar);   // the warpgroup is done reading H
        auto pre_vals = [&](int j, float (&v)[4]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = on(j, q) ? acc[4 * j + q] : 0.0f;
        };
        cond_partials(i - 1, pre_vals);
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int c = 8 * j + cA;
          float v[4];
          pre_vals(j, v);
          wgf::st_pair(H, rA, c, W, __floats2bfloat162_rn(v[0], v[1]));
          wgf::st_pair(H, rA + 8, c, W, __floats2bfloat162_rn(v[2], v[3]));
          colsum_pair(cs, W, ww, lane, cA, j, csp, v[0] + v[2],
                      v[1] + v[3]);
        }
        wg::fence_async_smem();
        wg::wg_sync(bar);
        colsum_out(cs, W, tw, bsum + lay.b[i - 1], live);
      }
    }
    wg::wg_sync(bar);
    for (int i = tw; i < 64 * 3; i += 128)
      if (live) a.d_pts[row0 * 3 + i] = dpts[i / 3][i % 3];
    wg::wg_sync(bar);
  }
  if (tw == 0) wgf::bulk_wait<0>();   // the workspace stores are done
}

// One weight gradient Aᵀ·D: A (rows x a_w) and D (rows x d_w) workspace
// regions; the output block (a_w x out_cols, row-major) sits at out_off of
// the flat gradient. Columns d_w > out_cols are zero padding. tiles_m
// output tiles of 128 rows of A's columns.
struct Prod {
  long a_col, d_col;
  int a_w, d_w, out_off, out_cols, tiles_m, tile0;
};

struct WgradArgs {
  const bf16* ws;
  long rows;             // rows of the pass (region height)
  long rows_per_split;   // a multiple of 64
  float* part;           // (n_split, n_w)
  long n_w;
  int n_prod;
  Prod p[kMaxProds];
};

struct __align__(128) WgradSmem {
  bf16 a[kWgStages][128 * 64];   // A tile: 64 rows × 128 of A's columns
  bf16 d[kWgStages][256 * 64];   // D tile: 64 rows × N columns
  uint64_t full[kWgStages];
  uint64_t empty[kWgStages];
};

template <int N>
__device__ __forceinline__ void wgrad_tile(const WgradArgs& a, const Prod& p,
                                           int m0, WgradSmem& s) {
  const long r_begin = (long)blockIdx.y * a.rows_per_split;
  const long r_end = r_begin + a.rows_per_split < a.rows
                         ? r_begin + a.rows_per_split : a.rows;
  const long kb0 = r_begin / 64, kb1 = r_end > r_begin ? r_end / 64 : kb0;
  const int a_cols = p.a_w - m0 < 128 ? p.a_w - m0 : 128;
  const int a_bytes = a_cols * 64 * 2, d_bytes = N * 64 * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= wgf::kConsumers / 32) {
    wg::setmaxnreg_dec<40>();
    if (warp == wgf::kConsumers / 32 && lane == 0) {
      const bf16* A = a.ws + p.a_col * a.rows + (long)m0 * 8;
      const bf16* Dm = a.ws + p.d_col * a.rows;
      int stage = 0;
      uint32_t phase = 0;
      for (long kb = kb0; kb < kb1; ++kb) {
        wg::mbar_wait(&s.empty[stage], phase ^ 1u);
        wg::mbar_expect_tx(&s.full[stage], a_bytes + d_bytes);
        // the tile's 8-row groups: a_cols × 16 bytes each, a_w × 16 apart
        for (int rg = 0; rg < 8; ++rg)
          wg::bulk_load(s.a[stage] + rg * 1024,
                        A + kb * p.a_w * 64 + rg * p.a_w * 8, a_bytes / 8,
                        &s.full[stage]);
        wg::bulk_load(s.d[stage], Dm + kb * N * 64, d_bytes, &s.full[stage]);
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }
  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, ww = (threadIdx.x & 127) >> 5;
  const bool run = m0 + 64 * g < p.a_w;   // this warpgroup's rows exist
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  int stage = 0, pend = -1;
  uint32_t phase = 0;
  for (long kb = kb0; kb < kb1; ++kb) {
    wg::mbar_wait(&s.full[stage], phase);
    wg::mma_fence();
    if (run) {
      // MN-major: 8-row (K) groups 2048 (A) and N·16 (D) bytes apart,
      // core matrices along MN 128 bytes apart; warpgroup 1 takes A's
      // columns 64-127
      const uint32_t aa = wg::smem_addr(s.a[stage]) + 1024u * g;
      const uint32_t da = wg::smem_addr(s.d[stage]);
#pragma unroll
      for (int ks = 0; ks < 64; ks += 16)
        wg::mma_mn<N>(acc, wg::desc_mn(aa + (ks >> 3) * 2048, 2048, 128),
                      wg::desc_mn(da + (ks >> 3) * N * 16, N * 16, 128));
    }
    wg::mma_commit();
    if (pend >= 0) {
      wg::mma_wait<1>();
      if (lane == 0) wg::mbar_arrive(&s.empty[pend]);
    }
    pend = stage;
    if (++stage == kWgStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  wg::mma_wait<0>();
  wg::fence_regs(acc);
  if (pend >= 0 && lane == 0) wg::mbar_arrive(&s.empty[pend]);
  float* dst = a.part + (long)blockIdx.y * a.n_w + p.out_off;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int m = m0 + 64 * g + 16 * ww + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    if (run && m < p.a_w && c < p.out_cols)
      dst[(long)m * p.out_cols + c] = acc[i];
  }
}

__global__ void __launch_bounds__(wgf::kThreads, 1)
    wgrad_kernel(const __grid_constant__ WgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WgradSmem& s = *reinterpret_cast<WgradSmem*>(smem_raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      wg::mbar_init(&s.full[i], 1);
      wg::mbar_init(&s.empty[i], wgf::kConsumers / 32);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  int pi = 0;
  while (pi + 1 < a.n_prod && a.p[pi + 1].tile0 <= (int)blockIdx.x) ++pi;
  const Prod& p = a.p[pi];
  const int m0 = ((int)blockIdx.x - p.tile0) * 128;
  switch (p.d_w) {
    case 256: wgrad_tile<256>(a, p, m0, s); break;
    case 128: wgrad_tile<128>(a, p, m0, s); break;
    case 64: wgrad_tile<64>(a, p, m0, s); break;
    default: wgrad_tile<16>(a, p, m0, s); break;
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

// d_dir[q][c] = Σ over the 64-row slabs that hold ray q of their partial,
// in slab order; the view term's (half = W / 2 columns) and the cond's
// (half = cw columns).
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

template <int W, bool kCond>
int launch_rows(RowsArgs& ra, int n_sm, int device, cudaStream_t st,
                bool launch) {
  const int smem = (int)sizeof(BwdSmem<W>);
  if (!launch)
    return (int)set_smem((const void*)bwd_rows_kernel<W, kCond>, device,
                         smem);
  const int items = (int)((ra.rows + wg::kItemRows - 1) / wg::kItemRows);
  bwd_rows_kernel<W, kCond><<<items < n_sm ? items : n_sm, wgf::kThreads,
                              smem, st>>>(ra);
  return (int)cudaGetLastError();
}

// launch false: only set the rows kernel's shared memory limit on device
int launch_rows_any(RowsArgs& ra, int n_sm, int device, cudaStream_t st,
                    bool launch) {
  const bool w256 = ra.lay.width == 256;
  if (ra.cw > 0)
    return w256 ? launch_rows<256, true>(ra, n_sm, device, st, launch)
                : launch_rows<128, true>(ra, n_sm, device, st, launch);
  return w256 ? launch_rows<256, false>(ra, n_sm, device, st, launch)
              : launch_rows<128, false>(ra, n_sm, device, st, launch);
}

}  // namespace
}  // namespace fnt

extern "C" {

// n must be a multiple of 64 and of spr, chunk a multiple of 64; width 128
// or 256, depth 2-8, k0 48 or 64; wp holds the net's field slices and
// their transposes (kernels/wgpack.py::field_buffer(net, True)). condpart:
// null, or (n / spr, cw) bf16 with cw = W times the layers that take the
// posenc operand; then d_cond (n / spr, cw) and cpart (n / 64, M, cw) f32.
// device: the operands' CUDA device. Returns a cudaError_t.
int fnt_field_backward(const void* pts, const void* dirpart, const void* w,
                       const void* wp, const void* b, const void* g_rgb,
                       const void* g_sigma, void* d_pts, void* d_dir,
                       void* d_w, void* d_b, void* ws, void* a0s,
                       void* masks, void* wpart, void* bpart, void* dpart,
                       const void* condpart, void* d_cond, void* cpart,
                       long ws_numel, int n,
                       int spr, int L, int depth, int width, int k0,
                       int skip_mask, int has_vd, int chunk, int n_split,
                       int M,
                       int cw, int device, void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout lay = make_layout(depth, width, k0, skip_mask, has_vd);
  const Regions reg = make_regions(lay);
  RowsArgs ra;
  ra.n_slices = wgf::field_slice_bytes(lay, true, ra.slice_bytes);
  if (wgf::field_layout_error(lay) || ra.n_slices < 0 || n < 0 ||
      n % kRows || chunk % kRows || chunk < kRows || spr < 1 || n % spr ||
      3 + 6 * L > k0 || n_split < 1 || M < 1 ||
      (long)chunk * reg.cols > ws_numel ||
      (reinterpret_cast<uintptr_t>(wp) & 15) ||
      (condpart != nullptr) != (cw > 0) ||
      (cw > 0 && (cw != wgf::cond_layers(lay) * width || !d_cond || !cpart ||
                  (reinterpret_cast<uintptr_t>(condpart) & 3))))
    return (int)cudaErrorInvalidValue;
  const int half = width / 2;
  const int n_w = has_vd ? lay.w_rgb + half * 3 : lay.w_out + width * 4;
  const int n_b = has_vd ? lay.b_rgb + 3 : lay.b_out + 4;
  // the weight-gradient products, in layout order
  WgradArgs wa{};
  int np = 0, tiles = 0;
  auto add = [&](long a_col, int a_w, long d_col, int d_w, int out_off,
                 int out_cols) {
    Prod& p = wa.p[np++];
    p.a_col = a_col; p.a_w = a_w; p.d_col = d_col; p.d_w = d_w;
    p.out_off = out_off; p.out_cols = out_cols;
    p.tiles_m = (a_w + 127) / 128;
    p.tile0 = tiles;
    tiles += p.tiles_m;
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

  ra.pts = static_cast<const float*>(pts);
  ra.dirpart = static_cast<const bf16*>(dirpart);
  ra.w = static_cast<const bf16*>(w);
  ra.wp = static_cast<const bf16*>(wp);
  ra.b = static_cast<const float*>(b);
  ra.g_rgb = static_cast<const float*>(g_rgb);
  ra.g_sigma = static_cast<const float*>(g_sigma);
  ra.d_pts = static_cast<float*>(d_pts);
  ra.dpart = static_cast<float*>(dpart);
  ra.bpart = static_cast<float*>(bpart);
  ra.ws = static_cast<bf16*>(ws);
  ra.a0s = static_cast<float*>(a0s);
  ra.masks = static_cast<uint32_t*>(masks);
  ra.condpart = static_cast<const bf16*>(condpart);
  ra.cpart = static_cast<float*>(cpart);
  ra.cw = cw;
  ra.last_skip = 0;
  for (int i = 1; i < depth; ++i)
    if (lay.w_a0[i] >= 0) ra.last_skip = i;
  ra.spr = spr; ra.L = L; ra.M = M; ra.n_b = n_b;
  ra.lay = lay;
  ra.reg = reg;

  int err = launch_rows_any(ra, 0, device, st, false);
  if (err) return err;
  cudaError_t e = set_smem((const void*)wgrad_kernel, device,
                           (int)sizeof(WgradSmem));
  if (e != cudaSuccess) return (int)e;
  int n_sm = 0;
  e = sm_count(device, &n_sm);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;

  for (long r0 = 0; r0 < n; r0 += chunk) {
    const long rows = n - r0 < chunk ? n - r0 : chunk;
    const int slabs = (int)(rows / kRows);
    ra.rows = rows;
    ra.r0 = r0;
    err = launch_rows_any(ra, n_sm, device, st, true);
    if (err) return err;
    wa.rows = rows;
    wa.rows_per_split = ((rows + n_split - 1) / n_split + 63) / 64 * 64;
    wgrad_kernel<<<dim3(tiles, n_split), wgf::kThreads, sizeof(WgradSmem),
                   st>>>(wa);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int acc = r0 > 0;
    sum_rows_kernel<<<(n_w + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(wpart), n_split, n_w,
        static_cast<float*>(d_w), acc);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    sum_rows_kernel<<<(n_b + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(bpart), slabs, n_b,
        static_cast<float*>(d_b), acc);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const long n_rays = n / spr;
  if (has_vd) {
    dir_sum_kernel<<<(int)((n_rays * half + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(dpart), static_cast<float*>(d_dir), n_rays,
        spr, M, half);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (cw > 0) {
    dir_sum_kernel<<<(int)((n_rays * cw + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(cpart), static_cast<float*>(d_cond),
        n_rays, spr, M, cw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
