// The wide field of mip-NeRF 360 (kernel K7): its IPE operand, the trunk
// layer by layer, and the NeRF MLP's head.
//
// Replaces no TPU kernel: the JAX package has no mip-NeRF 360. Added
// because the field kernels K3/K4/K6 keep a row tile's activations in
// shared memory from layer to layer, which stops at width 256: at width
// 1024, 64 rows in and out are 256 KB, above a block's 227 KB, and a
// 64 × 1024 f32 accumulator does not fit one SM's registers beside
// anything else.
//
// What bounds it on the H100: bf16 matrix products. A 1024 × 1024 layer
// does 2·1024² operations a row against 4 KB of bf16 activations read and
// written, ~512 operations a byte, above the card's ridge (~295); the
// limit is tensor-core throughput, then the L2 → shared-memory stream of
// the operand tiles (48 KB a 64-deep step of a 128 × 256 output tile).
//
// Design (kernels/widefield.py packs the weights):
// - Layouts. Activations live in device memory as 64 × 64 bf16 blocks in
//   wgmma's no-swizzle core-matrix order (block (row block, column block)
//   at (rb · W/64 + cb) · 4096 elements), so one bulk copy of 8 KB puts a
//   block into shared memory as wgmma reads it; each layer's epilogue
//   writes its output so. Weights: per layer and 256-column output block,
//   its [h | IPE] rows in 64 × 256 slices (wgpack's order), 32 KB each.
// - ipe_kernel: the IPE operand from the Gaussians (mean, diag Σ of each
//   row, f32): [sin(2^l μ) e^{-4^l σ²/2} | sin(2^l μ + π/2) e^{…}] over
//   l = 0 … L−1 and the three axes, zero beyond 6L, 128 columns in bf16.
//   Phases and variances are scaled by powers of two (exact) and the π/2
//   added by __fadd_rn, as the plain version rounds.
// - layer_kernel: one trunk layer over the launch's rows, out = bf16(relu(
//   [h | IPE] · W + b)). Persistent blocks, one per SM, of two consumer
//   warpgroups and one producer warpgroup (setmaxnreg moves the registers
//   to the consumers). An output tile is 128 rows × 256 columns, 64 rows a
//   consumer warpgroup on wgmma m64n256k16, tiles ordered with the column
//   block innermost so that the blocks running together share their rows'
//   A blocks in L2. The producer's one lane streams, for each 64-deep step,
//   the two warpgroups' A blocks and the B slice through a ring of kStages
//   stages behind full/empty mbarriers; a consumer releases a stage once
//   the wgmmas after it have been issued. The epilogue runs in registers
//   and stores bf16 pairs straight to device memory (a warp's 32 lanes fill
//   one 128-byte core matrix). The last trunk layer also takes the σ head:
//   each row's dot product with the bf16 activations over the tile's 256
//   columns, reduced over the 4 lanes of a row, written as one partial a
//   column block (fixed order, no atomics), or σ itself at width 256
//   without a head.
// - head_kernel (the NeRF MLP): the bottleneck (W → 256, no activation) on
//   the same loop, its bf16 output kept in shared memory as the A operand
//   of the view layer (256 → 128, m64n128k16, whose four slices follow in
//   the ring); the view epilogue adds the per-ray view term (f32) and the
//   bias, relu, bf16, then the rgb head as register dot products reduced
//   over the 4 lanes, the padded sigmoid, and σ = Σ partials + b.
#include "fnt_common.cuh"
#include "wg_trunk.cuh"

namespace fnt {
namespace {

constexpr int kIpeCols = 128;          // the IPE operand, zero-padded
constexpr int kTileN = 256;            // output columns of a tile
constexpr int kBlk = 64 * 64;          // elements of an activation block
constexpr int kSliceN = 64 * kTileN;   // elements of a weight slice
constexpr int kBn = 256, kView = 128;  // the head's widths
constexpr int kThreads = 3 * 128;      // two consumers and a producer
constexpr int kConsumerWarps = 8;
constexpr int kMaxW = 1024;
constexpr int kMaxDepthW = 8;
constexpr int kLayerStages = 4;
constexpr int kHeadStages = 3;
constexpr float kRgbPad = 0.001f;

// Offsets into the weight slices and the f32 buffer; must equal
// kernels/widefield.py::wide_layout.
struct WideLayout {
  int depth, width, nt, has_vd;
  long w[kMaxDepthW];
  int kb_h[kMaxDepthW], kb_a[kMaxDepthW], b[kMaxDepthW];
  int sig, b_sig;
  long bn, view;
  int b_bn, b_view, rgb, b_rgb, n_b;
};

inline WideLayout make_wide_layout(int depth, int width, int skip_mask,
                                   int has_vd) {
  WideLayout L{};
  L.depth = depth; L.width = width; L.nt = width / kTileN;
  L.has_vd = has_vd;
  long wo = 0;
  for (int i = 0; i < depth; ++i) {
    L.w[i] = wo;
    L.kb_h[i] = i > 0 ? width / 64 : 0;
    L.kb_a[i] = (i == 0 || ((skip_mask >> i) & 1)) ? kIpeCols / 64 : 0;
    L.b[i] = i * width;
    wo += (long)L.nt * (L.kb_h[i] + L.kb_a[i]) * kSliceN;
  }
  L.sig = depth * width;
  L.b_sig = L.sig + width;
  int bo = L.b_sig + 4;
  L.bn = L.view = -1;
  L.b_bn = L.b_view = L.rgb = L.b_rgb = -1;
  if (has_vd) {
    L.bn = wo;
    wo += (long)(width / 64) * 64 * kBn;
    L.view = wo;
    L.b_bn = bo;
    L.b_view = bo + kBn;
    L.rgb = L.b_view + kView;
    L.b_rgb = L.rgb + 3 * kView;
    bo = L.b_rgb + 4;
  }
  L.n_b = bo;
  return L;
}

template <int S>
struct __align__(128) Ring {
  bf16 a[S][2][kBlk];          // the two warpgroups' A blocks
  bf16 b[S][kSliceN];          // a weight slice
  uint64_t full[S];
  uint64_t empty[S];
};

template <int S>
__device__ __forceinline__ void ring_init(Ring<S>& r) {
  for (int i = 0; i < S; ++i) {
    wg::mbar_init(&r.full[i], 1);
    wg::mbar_init(&r.empty[i], kConsumerWarps);
  }
  wg::mbar_init_fence();
}

struct Pos {
  int stage;
  uint32_t phase;
};

template <int S>
__device__ __forceinline__ void advance(Pos& p) {
  if (++p.stage == S) {
    p.stage = 0;
    p.phase ^= 1u;
  }
}

// The producer lane: for each of the block's tiles, every 64-deep step of
// [h | IPE] (the two A blocks and the B slice), then `extra` B slices of
// extra_bytes each from `extra_src` (the head's view layer).
template <int S>
__device__ void produce(Ring<S>& r, const bf16* h_in, const bf16* a_in,
                        int kb_h, int kb_a, const bf16* w, int n_mt, int nt,
                        const bf16* extra_src, int extra, int extra_bytes) {
  Pos p{0, 0u};
  const int kb_n = kb_h + kb_a;
  for (int t = blockIdx.x; t < n_mt * nt; t += gridDim.x) {
    const long mt = t / nt;
    const int ntile = t % nt;
    for (int kb = 0; kb < kb_n; ++kb) {
      wg::mbar_wait(&r.empty[p.stage], p.phase ^ 1u);
      wg::mbar_expect_tx(&r.full[p.stage], 2 * kBlk * 2 + kSliceN * 2);
      for (int g = 0; g < 2; ++g) {
        const long rb = 2 * mt + g;
        const bf16* src = kb < kb_h
                              ? h_in + (rb * kb_h + kb) * kBlk
                              : a_in + (rb * kb_a + (kb - kb_h)) * kBlk;
        wg::bulk_load(r.a[p.stage][g], src, kBlk * 2, &r.full[p.stage]);
      }
      wg::bulk_load(r.b[p.stage], w + ((long)ntile * kb_n + kb) * kSliceN,
                    kSliceN * 2, &r.full[p.stage]);
      advance<S>(p);
    }
    for (int e = 0; e < extra; ++e) {
      wg::mbar_wait(&r.empty[p.stage], p.phase ^ 1u);
      wg::mbar_expect_tx(&r.full[p.stage], extra_bytes);
      wg::bulk_load(r.b[p.stage],
                    reinterpret_cast<const char*>(extra_src) +
                        (long)e * extra_bytes,
                    extra_bytes, &r.full[p.stage]);
      advance<S>(p);
    }
  }
}

template <int S>
__device__ __forceinline__ void release(Ring<S>& r, int stage) {
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&r.empty[stage]);
}

// acc = A · B over kb_n steps of the ring, A the warpgroup's blocks.
template <int S>
__device__ __forceinline__ void mainloop(Ring<S>& r, Pos& p, int g,
                                         int kb_n, float (&acc)[128]) {
  int pend = -1;
  for (int kb = 0; kb < kb_n; ++kb) {
    wg::mbar_wait(&r.full[p.stage], p.phase);
    wg::mma_fence();
    wg::mma_slice<kTileN>(acc, wg::smem_addr(r.a[p.stage][g]), 64, 0,
                          wg::smem_addr(r.b[p.stage]), 64, kb == 0);
    wg::mma_commit();
    if (pend >= 0) {
      wg::mma_wait<1>();
      release(r, pend);
    }
    pend = p.stage;
    advance<S>(p);
  }
  wg::mma_wait<0>();
  wg::fence_regs(acc);
  release(r, pend);
}

__device__ __forceinline__ void st_pair(bf16* blk, int r, int c,
                                        __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(blk) +
                                     wg::cm_off(r, c, 64)) = v;
}

// ---- the IPE operand ------------------------------------------------------

__global__ void ipe_kernel(const float* __restrict__ mean,
                           const float* __restrict__ var, bf16* out, int n,
                           int L) {
  const long n_pairs = (long)n * (kIpeCols / 2);
  const int n_feat = 6 * L, third = 3 * L;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_pairs;
       i += (long)gridDim.x * blockDim.x) {
    const long blk = i >> 11;            // 2048 pairs a 64 × 64 block
    const int in = (int)(i & 2047);
    const int cm = in >> 5;
    const int r = (cm & 7) * 8 + ((in & 31) >> 2);
    const int c0 = (cm >> 3) * 8 + (in & 3) * 2;
    const long row = (blk >> 1) * 64 + r;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = (int)(blk & 1) * 64 + c0 + e;
      v[e] = 0.0f;
      if (c < n_feat) {
        const int half = c >= third;
        const int rem = c - half * third;
        const int l = rem / 3, ax = rem % 3;
        const float sc = (float)(1 << l);
        float ph = __fmul_rn(mean[row * 3 + ax], sc);
        if (half) ph = __fadd_rn(ph, kHalfPi);
        const float att =
            expf(__fmul_rn(-0.5f, __fmul_rn(var[row * 3 + ax],
                                            __fmul_rn(sc, sc))));
        v[e] = __fmul_rn(sinf(ph), att);
      }
    }
    st_pair(out + blk * kBlk, r, c0, __floats2bfloat162_rn(v[0], v[1]));
  }
}

// ---- one trunk layer ------------------------------------------------------

struct LayerArgs {
  const bf16* h_in;      // (n/64, W/64) blocks, or null (the first layer)
  const bf16* a_in;      // the IPE operand, (n/64, 2) blocks
  const bf16* w;         // the layer's slices
  const float* bias;     // (W)
  const float* wsig;     // (W) σ head on the last layer, else null
  const float* b_sig;    // σ's bias (with wsig and direct)
  bf16* out;             // (n/64, W/64) blocks
  float* part;           // (n, W/256) σ partials (last layer, not direct)
  float* sigma;          // (n) σ (last layer, direct)
  int n, W, kb_h, kb_a;
  int direct;            // σ itself: width 256 and no head after
};

struct __align__(128) LayerSmem {
  Ring<kLayerStages> ring;
  float bias[kMaxW];
  float wsig[kMaxW];
};

__global__ void __launch_bounds__(kThreads, 1)
    layer_kernel(const __grid_constant__ LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  LayerSmem& s = *reinterpret_cast<LayerSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = a.W / kTileN, n_mt = a.n / 128;
  if (threadIdx.x == 0) ring_init(s.ring);
  for (int i = threadIdx.x; i < a.W; i += blockDim.x) {
    s.bias[i] = a.bias[i];
    s.wsig[i] = a.wsig ? a.wsig[i] : 0.0f;
  }
  __syncthreads();
  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0)
      produce(s.ring, a.h_in, a.a_in, a.kb_h, a.kb_a, a.w, n_mt, nt,
              (const bf16*)nullptr, 0, 0);
    return;
  }
  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, ww = (threadIdx.x & 127) >> 5;
  const int rA = 16 * ww + (lane >> 2), cA = 2 * (lane & 3);
  const float b_sig = (a.wsig && a.direct) ? *a.b_sig : 0.0f;
  Pos p{0, 0u};
  float acc[128];
  for (int t = blockIdx.x; t < n_mt * nt; t += gridDim.x) {
    const long mt = t / nt;
    const int ntile = t % nt;
    mainloop(s.ring, p, g, a.kb_h + a.kb_a, acc);
    const long rb = 2 * mt + g;
    bf16* out = a.out + rb * (a.W / 64) * kBlk;
    float sg_lo = 0.0f, sg_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      const int col = ntile * kTileN + 8 * j + cA;
      const float b0 = s.bias[col], b1 = s.bias[col + 1];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          fmaxf(acc[4 * j] + b0, 0.0f), fmaxf(acc[4 * j + 1] + b1, 0.0f));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          fmaxf(acc[4 * j + 2] + b0, 0.0f), fmaxf(acc[4 * j + 3] + b1, 0.0f));
      bf16* blk = out + (col >> 6) * kBlk;
      st_pair(blk, rA, col & 63, lo);
      st_pair(blk, rA + 8, col & 63, hi);
      if (a.wsig) {
        const float w0 = s.wsig[col], w1 = s.wsig[col + 1];
        sg_lo += bf(lo.x) * w0 + bf(lo.y) * w1;
        sg_hi += bf(hi.x) * w0 + bf(hi.y) * w1;
      }
    }
    if (a.wsig) {
      sg_lo += __shfl_xor_sync(0xffffffffu, sg_lo, 1);
      sg_lo += __shfl_xor_sync(0xffffffffu, sg_lo, 2);
      sg_hi += __shfl_xor_sync(0xffffffffu, sg_hi, 1);
      sg_hi += __shfl_xor_sync(0xffffffffu, sg_hi, 2);
      if ((lane & 3) == 0) {
        const long r_lo = rb * 64 + rA, r_hi = r_lo + 8;
        if (a.direct) {
          a.sigma[r_lo] = sg_lo + b_sig;
          a.sigma[r_hi] = sg_hi + b_sig;
        } else {
          a.part[r_lo * nt + ntile] = sg_lo;
          a.part[r_hi * nt + ntile] = sg_hi;
        }
      }
    }
  }
}

// ---- the NeRF MLP's head ---------------------------------------------------

struct HeadArgs {
  const bf16* h_in;      // the last trunk layer's blocks
  const bf16* w_bn;      // the bottleneck's slices, then the view layer's
  const float* dirpart;  // (n / spr, 128) per-ray view term
  const float* b;        // the f32 buffer
  const float* part;     // (n, W/256) σ partials
  float* rgb;            // (n, 3)
  float* sigma;          // (n)
  int n, W, spr;
  WideLayout lay;
};

struct __align__(128) HeadSmem {
  Ring<kHeadStages> ring;
  bf16 t[2][64 * kBn];   // the bottleneck, A of the view layer
  float b_bn[kBn];
  float b_view[kView];
  float wrgb[3 * kView];
  float b_rgb[4];
};

__global__ void __launch_bounds__(kThreads, 1)
    head_kernel(const __grid_constant__ HeadArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  HeadSmem& s = *reinterpret_cast<HeadSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_mt = a.n / 128, kb_h = a.W / 64, nt = a.W / kTileN;
  const WideLayout& lay = a.lay;
  if (threadIdx.x == 0) ring_init(s.ring);
  for (int i = threadIdx.x; i < kBn; i += blockDim.x)
    s.b_bn[i] = a.b[lay.b_bn + i];
  for (int i = threadIdx.x; i < kView; i += blockDim.x)
    s.b_view[i] = a.b[lay.b_view + i];
  for (int i = threadIdx.x; i < 3 * kView; i += blockDim.x)
    s.wrgb[i] = a.b[lay.rgb + i];
  if (threadIdx.x < 3) s.b_rgb[threadIdx.x] = a.b[lay.b_rgb + threadIdx.x];
  __syncthreads();
  const bf16* w_view = a.w_bn + (long)kb_h * kSliceN;
  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0)
      produce(s.ring, a.h_in, (const bf16*)nullptr, kb_h, 0, a.w_bn, n_mt,
              1, w_view, kBn / 64, 64 * kView * 2);
    return;
  }
  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, ww = (threadIdx.x & 127) >> 5;
  const int rA = 16 * ww + (lane >> 2), cA = 2 * (lane & 3);
  const float b_sig = a.b[lay.b_sig];
  bf16* T = s.t[g];
  Pos p{0, 0u};
  float acc[128];
  for (int mt = blockIdx.x; mt < n_mt; mt += gridDim.x) {
    mainloop(s.ring, p, g, kb_h, acc);
    wg::wg_sync(1 + g);   // the last tile's view products are done with T
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
      const int c = 8 * j + cA;
      const float b0 = s.b_bn[c], b1 = s.b_bn[c + 1];
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(acc[4 * j] + b0, acc[4 * j + 1] + b1);
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(T) +
                                         wg::cm_off(rA, c, kBn)) = lo;
      *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(T) +
                                         wg::cm_off(rA + 8, c, kBn)) = hi;
    }
    wg::fence_async_smem();
    wg::wg_sync(1 + g);
    // the view layer: 256 → 128 over four slices of the ring
    float acc2[kView / 2];
    int pend = -1;
    for (int kb = 0; kb < kBn / 64; ++kb) {
      wg::mbar_wait(&s.ring.full[p.stage], p.phase);
      wg::mma_fence();
      wg::mma_slice<kView>(acc2, wg::smem_addr(T), kBn, kb * 64,
                           wg::smem_addr(s.ring.b[p.stage]), 64, kb == 0);
      wg::mma_commit();
      if (pend >= 0) {
        wg::mma_wait<1>();
        release(s.ring, pend);
      }
      pend = p.stage;
      advance<kHeadStages>(p);
    }
    wg::mma_wait<0>();
    wg::fence_regs(acc2);
    release(s.ring, pend);
    const long r_lo = (long)mt * 128 + 64 * g + rA, r_hi = r_lo + 8;
    const float* dp_lo = a.dirpart + (r_lo / a.spr) * kView;
    const float* dp_hi = a.dirpart + (r_hi / a.spr) * kView;
    float c_lo[3] = {0.0f, 0.0f, 0.0f}, c_hi[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kView / 8; ++j) {
      const int c = 8 * j + cA;
      const float b0 = s.b_view[c], b1 = s.b_view[c + 1];
      const float v0 = bf(__float2bfloat16_rn(
          fmaxf(acc2[4 * j] + dp_lo[c] + b0, 0.0f)));
      const float v1 = bf(__float2bfloat16_rn(
          fmaxf(acc2[4 * j + 1] + dp_lo[c + 1] + b1, 0.0f)));
      const float v2 = bf(__float2bfloat16_rn(
          fmaxf(acc2[4 * j + 2] + dp_hi[c] + b0, 0.0f)));
      const float v3 = bf(__float2bfloat16_rn(
          fmaxf(acc2[4 * j + 3] + dp_hi[c + 1] + b1, 0.0f)));
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        c_lo[q] += v0 * s.wrgb[c * 3 + q] + v1 * s.wrgb[(c + 1) * 3 + q];
        c_hi[q] += v2 * s.wrgb[c * 3 + q] + v3 * s.wrgb[(c + 1) * 3 + q];
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      c_lo[q] += __shfl_xor_sync(0xffffffffu, c_lo[q], 1);
      c_lo[q] += __shfl_xor_sync(0xffffffffu, c_lo[q], 2);
      c_hi[q] += __shfl_xor_sync(0xffffffffu, c_hi[q], 1);
      c_hi[q] += __shfl_xor_sync(0xffffffffu, c_hi[q], 2);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        a.rgb[r_lo * 3 + q] =
            sigmoidf(c_lo[q] + s.b_rgb[q]) * (1.0f + 2.0f * kRgbPad) - kRgbPad;
        a.rgb[r_hi * 3 + q] =
            sigmoidf(c_hi[q] + s.b_rgb[q]) * (1.0f + 2.0f * kRgbPad) - kRgbPad;
      }
      float s_lo = b_sig, s_hi = b_sig;
      for (int k = 0; k < nt; ++k) {
        s_lo += a.part[r_lo * nt + k];
        s_hi += a.part[r_hi * nt + k];
      }
      a.sigma[r_lo] = s_lo;
      a.sigma[r_hi] = s_hi;
    }
  }
}

template <class Kernel, class Args>
int launch(Kernel kernel, const Args& a, int smem, int n_tiles, int device,
           cudaStream_t st) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)kernel, device, smem);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_tiles < n_sm ? n_tiles : n_sm, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fnt

extern "C" {

// mip-NeRF 360's net on n rows (a multiple of 128; spr rows a ray): the
// IPE operand from mean and var ((n, 3) f32), the trunk of `depth` layers
// of width 256 or 1024 (skip_mask: bit i for each layer i > 0 that takes
// the IPE operand again, at most one), σ (n) raw; with has_vd the head:
// dirpart (n / spr, 128) f32, rgb (n, 3) after the padded sigmoid. wp, b:
// kernels/widefield.py's buffers. h0, h1: two (n, width) bf16 workspaces;
// a0: (n, 128) bf16; part: (n, width / 256) f32. device: the operands'
// CUDA device. Returns a cudaError_t.
int fnt_wide_field(const void* mean, const void* var, const void* dirpart,
                   const void* wp, const void* b, void* h0, void* h1,
                   void* a0, void* part, void* rgb, void* sigma, int n,
                   int spr, int L, int depth, int width, int skip_mask,
                   int has_vd, int device, void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  if (n < 0 || n % 128 || spr < 1 || n % spr || L < 1 ||
      6 * L > kIpeCols || !(width == 256 || width == 1024) || depth < 1 ||
      depth > kMaxDepthW || (skip_mask & 1) || (skip_mask >> depth) ||
      __builtin_popcount(skip_mask) > 1 || (has_vd && dirpart == nullptr) ||
      (reinterpret_cast<uintptr_t>(wp) & 15) ||
      (reinterpret_cast<uintptr_t>(h0) & 15) ||
      (reinterpret_cast<uintptr_t>(h1) & 15) ||
      (reinterpret_cast<uintptr_t>(a0) & 15))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WideLayout lay = make_wide_layout(depth, width, skip_mask, has_vd);
  const bf16* w = static_cast<const bf16*>(wp);
  const float* fb = static_cast<const float*>(b);
  bf16* ipe_op = static_cast<bf16*>(a0);
  int n_sm = 0;
  cudaError_t err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return (int)err;
  const long n_pairs = (long)n * (kIpeCols / 2);
  const long want = (n_pairs + 255) / 256;
  ipe_kernel<<<(int)(want < 16L * n_sm ? want : 16L * n_sm), 256, 0, st>>>(
      static_cast<const float*>(mean), static_cast<const float*>(var), ipe_op,
      n, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bf16* bufs[2] = {static_cast<bf16*>(h0), static_cast<bf16*>(h1)};
  const int nt = width / kTileN;
  for (int i = 0; i < depth; ++i) {
    const bool last = i == depth - 1;
    LayerArgs la;
    la.h_in = i > 0 ? bufs[(i - 1) & 1] : nullptr;
    la.a_in = ipe_op;
    la.w = w + lay.w[i];
    la.bias = fb + lay.b[i];
    la.wsig = last ? fb + lay.sig : nullptr;
    la.b_sig = fb + lay.b_sig;
    la.out = bufs[i & 1];
    la.part = static_cast<float*>(part);
    la.sigma = static_cast<float*>(sigma);
    la.n = n;
    la.W = width;
    la.kb_h = lay.kb_h[i];
    la.kb_a = lay.kb_a[i];
    la.direct = nt == 1 && !has_vd;
    const int code = launch(layer_kernel, la, (int)sizeof(LayerSmem),
                            (n / 128) * nt, device, st);
    if (code) return code;
  }
  if (!has_vd) return 0;
  HeadArgs ha;
  ha.h_in = bufs[(depth - 1) & 1];
  ha.w_bn = w + lay.bn;
  ha.dirpart = static_cast<const float*>(dirpart);
  ha.b = fb;
  ha.part = static_cast<const float*>(part);
  ha.rgb = static_cast<float*>(rgb);
  ha.sigma = static_cast<float*>(sigma);
  ha.n = n;
  ha.W = width;
  ha.spr = spr;
  ha.lay = lay;
  return launch(head_kernel, ha, (int)sizeof(HeadSmem), n / 128, device, st);
}

}  // extern "C"
