// The wide field of mip-NeRF 360 (kernel K7): its IPE operand, the trunk
// layer by layer, and the NeRF MLP's head; for training, the same forward
// with its activations kept, and the backward (after the forward's
// kernels below: dgrad, wgrad, the head's backward, column sums).
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
  uint4* mask;           // kMask: the output's ReLU bits, a tile's 2 KB
  int n, W, kb_h, kb_a;
  int direct;            // σ itself: width 256 and no head after
};

struct __align__(128) LayerSmem {
  Ring<kLayerStages> ring;
  float bias[kMaxW];
  float wsig[kMaxW];
};

// kMask (training): each consumer thread also writes the ReLU bits of its
// 128 outputs of a tile (bit 4·(j % 8) + e of word j / 8: e = the pair's
// first and second column in row rA, then in row rA + 8) as one uint4,
// at ((row block) · (W/256) + column tile) · 128 + its index in the
// warpgroup: dgrad_kernel's thread of the same tile position reads them
// back as its mask.
template <bool kMask>
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
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
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
      if (kMask)
        bits[j >> 3] |= ((bf(lo.x) > 0.0f ? 1u : 0u) |
                         (bf(lo.y) > 0.0f ? 2u : 0u) |
                         (bf(hi.x) > 0.0f ? 4u : 0u) |
                         (bf(hi.y) > 0.0f ? 8u : 0u))
                        << (4 * (j & 7));
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
    if (kMask)
      a.mask[(rb * nt + ntile) * 128 + (threadIdx.x & 127)] =
          make_uint4(bits[0], bits[1], bits[2], bits[3]);
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
  bf16* bn_out;          // kSave: the bottleneck, (n/64, 4) blocks
  bf16* v_out;           // kSave: the view layer, (n/64, 2) blocks
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

// kSave (training): the bottleneck's and the view layer's bf16 outputs
// also go to device memory in the activation layout, for the backward.
template <bool kSave>
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
      if (kSave) {
        bf16* blk = a.bn_out + (((long)mt * 2 + g) * (kBn / 64) + (c >> 6)) *
                                   kBlk;
        st_pair(blk, rA, c & 63, lo);
        st_pair(blk, rA + 8, c & 63, hi);
      }
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
      if (kSave) {
        bf16* blk = a.v_out + (((long)mt * 2 + g) * (kView / 64) + (c >> 6)) *
                                  kBlk;
        st_pair(blk, rA, c & 63, __floats2bfloat162_rn(v0, v1));
        st_pair(blk, rA + 8, c & 63, __floats2bfloat162_rn(v2, v3));
      }
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

// ---- the training backward --------------------------------------------------
//
// Design (kernels/widefield.py drives it; rounding as the plain version,
// widefield.py::wide_bwd_plain): the cotangent of every bf16 activation
// is rounded to bf16, masked by its ReLU (the kept output > 0) and stored
// in the activation layout, the A operand of the next input gradient and
// the B operand of the layer's weight gradient. Three kernels on the
// forward's loop and layout:
// - dgrad_kernel: one layer's input gradient, out = mask(h) ⊙ bf16(dZ ·
//   Wᵀ [+ gσ ⊗ w_σ]) over 128 × 256 tiles, the layer kernel's producer
//   and ring with the transposed weights' slices as B. The mask is the
//   ReLU bits the training forward wrote (layer_kernel<true>), a uint4 a
//   thread and tile in the accumulator's own layout, read under the
//   tile's products: reading the kept output's bf16 pairs in the epilogue
//   instead, a latency round trip for each of the 32 column steps, had
//   taken as long as the products, and staging them in shared memory
//   cost the ring a stage. With no A operand
//   (the proposal's last layer: σ is all its head) the products are
//   skipped.
// - colsum_kernel: the bias gradients (a layer's cotangent summed over
//   the rows) and the σ head's (the last layer's output weighted by gσ),
//   one pass over the activation layout at the memory's rate, in partials
//   a chunk of rows summed in a fixed order afterwards.
// - wgrad_kernel: weight gradients Aᵀ·D with the rows as K, on wgmma with
//   both operands MN-major (K4's transpose bits): a 128 × N output tile a
//   block (N = 256, or 128 for the view layer) over a split of the rows,
//   written as a partial a split. A's 64 × 64 blocks come in by one bulk
//   copy each; D's N columns of a 64-row step by 1 KB copies, one a block
//   and 8-row group, so that its core matrices lie N-contiguous.
// - head_bwd_kernel (the NeRF MLP): a thread a view column runs the rgb
//   head's and the view layer's backward over a tile's rows (the sigmoid's
//   derivative from the kept rgb, the mask from the kept view output), the
//   per-ray view term's cotangent summed over each ray's rows (rays of a
//   divisor of 64 rows: a ray never leaves a warpgroup's rows), the rgb
//   head's gradient and the view bias's in registers; then the bottleneck's
//   cotangent dzv · W_vbᵀ on wgmma from shared memory, rounded.
// No float atomics: the same inputs give bitwise the same gradients.

constexpr int kWgStages = 4;
constexpr int kHeadPart = 3 * kView + kView + 4;   // per warpgroup partials

__device__ __forceinline__ __nv_bfloat162 ld_pair(const bf16* blk, int r,
                                                  int c) {
  return *reinterpret_cast<const __nv_bfloat162*>(
      reinterpret_cast<const char*>(blk) + wg::cm_off(r, c, 64));
}

struct DgradArgs {
  const bf16* a_in;      // (n/64, kb) blocks: the layer above's cotangent
  const bf16* w;         // the transposed weights' slices, (W/256) × kb
  const uint4* mask;     // the layer's ReLU bits (layer_kernel<true>)
  const float* g_sigma;  // (n) σ's cotangent (last layer), else null
  const float* wsig;     // (W) the σ head (with g_sigma)
  bf16* out;             // (n/64, W/64) blocks
  int n, W, kb;
};

struct __align__(128) DgradSmem {
  Ring<kLayerStages> ring;
  float wsig[kMaxW];
};

__global__ void __launch_bounds__(kThreads, 1)
    dgrad_kernel(const __grid_constant__ DgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DgradSmem& s = *reinterpret_cast<DgradSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = a.W / kTileN, n_mt = a.n / 128;
  const bool gs = a.g_sigma != nullptr;
  if (threadIdx.x == 0) ring_init(s.ring);
  for (int i = threadIdx.x; i < a.W; i += blockDim.x)
    s.wsig[i] = gs ? a.wsig[i] : 0.0f;
  __syncthreads();
  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0 && a.kb > 0)
      produce(s.ring, a.a_in, (const bf16*)nullptr, a.kb, 0, a.w, n_mt, nt,
              (const bf16*)nullptr, 0, 0);
    return;
  }
  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, ww = (threadIdx.x & 127) >> 5;
  const int rA = 16 * ww + (lane >> 2), cA = 2 * (lane & 3);
  Pos p{0, 0u};
  float acc[128];
  for (int t = blockIdx.x; t < n_mt * nt; t += gridDim.x) {
    const long mt = t / nt;
    const int ntile = t % nt;
    const long rb = 2 * mt + g;
    // this thread's mask bits of the tile, read under the products
    const uint4 m4 = a.mask[(rb * nt + ntile) * 128 + (threadIdx.x & 127)];
    if (a.kb > 0) {
      mainloop(s.ring, p, g, a.kb, acc);
    } else {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    }
    const uint32_t bits[4] = {m4.x, m4.y, m4.z, m4.w};
    const long r_lo = rb * 64 + rA;
    const float gs_lo = gs ? a.g_sigma[r_lo] : 0.0f;
    const float gs_hi = gs ? a.g_sigma[r_lo + 8] : 0.0f;
    bf16* out = a.out + rb * (a.W / 64) * kBlk;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      const int col = ntile * kTileN + 8 * j + cA;
      const float w0 = s.wsig[col], w1 = s.wsig[col + 1];
      const uint32_t mb = bits[j >> 3] >> (4 * (j & 7));
      const float v0 = (mb & 1u) ? acc[4 * j] + gs_lo * w0 : 0.0f;
      const float v1 = (mb & 2u) ? acc[4 * j + 1] + gs_lo * w1 : 0.0f;
      const float v2 = (mb & 4u) ? acc[4 * j + 2] + gs_hi * w0 : 0.0f;
      const float v3 = (mb & 8u) ? acc[4 * j + 3] + gs_hi * w1 : 0.0f;
      bf16* blk = out + (col >> 6) * kBlk;
      st_pair(blk, rA, col & 63, __floats2bfloat162_rn(v0, v1));
      st_pair(blk, rA + 8, col & 63, __floats2bfloat162_rn(v2, v3));
    }
  }
}

// part[blockIdx.y][c] = Σ over the rows of the chunk of w_r · X[r, c] (w_r
// = 1 without w): X (n/64, C/64) blocks, one column block a CUDA block,
// rb_per_chunk row blocks a chunk. A thread reads 16 bytes (8 columns of
// a row) at a time; the 32 threads that hold a column group sum them last
// in a fixed order.
__global__ void __launch_bounds__(256)
    colsum_kernel(const bf16* __restrict__ X, const float* __restrict__ w,
                  int n, int C, long rb_per_chunk, float* part) {
  __shared__ float red[256][9];
  const int cb = blockIdx.x, t = threadIdx.x;
  const long n_rb = n / 64, rb0 = (long)blockIdx.y * rb_per_chunk;
  const long rb1 = rb0 + rb_per_chunk < n_rb ? rb0 + rb_per_chunk : n_rb;
  const int r0 = (t >> 6) * 8 + (t & 7);
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  for (long rb = rb0; rb < rb1; ++rb) {
    const uint4* blk =
        reinterpret_cast<const uint4*>(X + (rb * (C / 64) + cb) * kBlk);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint4 v = blk[t + 256 * half];
      const float wr = w ? w[rb * 64 + r0 + 32 * half] : 1.0f;
      const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * e] += wr * bf(q[e].x);
        acc[2 * e + 1] += wr * bf(q[e].y);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[t][e] = acc[e];
  __syncthreads();
  if (t < 64) {
    const int cg = t >> 3, e = t & 7;
    float sum = 0.0f;
    for (int q = 0; q < 4; ++q)
      for (int k = 0; k < 8; ++k) sum += red[q * 64 + cg * 8 + k][e];
    part[(long)blockIdx.y * C + cb * 64 + t] = sum;
  }
}

// One weight gradient Aᵀ·D over the rows: A (n/64, a_cb) blocks, of which
// columns [0, m) are read; D (n/64, d_cb) blocks, columns [0, n_cols); the
// output (m × n_cols, row-major) at `out` of each split's partial.
struct WProd {
  const bf16* A;
  const bf16* D;
  long out;
  int a_cb, d_cb, m, n_cols, tile_n, tiles_m, tiles_n, tile0;
};

struct WgradArgs {
  WProd p[2];
  int n_prod;
  long rows, rows_per_split;
  float* part;           // (gridDim.y, slab)
  long slab;
};

struct __align__(128) WgradSmem {
  bf16 a[kWgStages][2][kBlk];
  bf16 d[kWgStages][64 * kTileN];
  uint64_t full[kWgStages];
  uint64_t empty[kWgStages];
};

template <int N>
__device__ __forceinline__ void wgrad_tile(const WgradArgs& a, const WProd& p,
                                           int mt, int ntile, WgradSmem& s) {
  const long r_begin = (long)blockIdx.y * a.rows_per_split;
  const long r_end = r_begin + a.rows_per_split < a.rows
                         ? r_begin + a.rows_per_split : a.rows;
  const long kb0 = r_begin / 64, kb1 = r_end > r_begin ? r_end / 64 : kb0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long kb = kb0; kb < kb1; ++kb) {
        wg::mbar_wait(&s.empty[stage], phase ^ 1u);
        wg::mbar_expect_tx(&s.full[stage], 2 * kBlk * 2 + 64 * N * 2);
        for (int g = 0; g < 2; ++g)
          wg::bulk_load(s.a[stage][g],
                        p.A + (kb * p.a_cb + 2 * mt + g) * kBlk, kBlk * 2,
                        &s.full[stage]);
        const bf16* src = p.D + (kb * p.d_cb + ntile * (N / 64)) * kBlk;
        for (int rg = 0; rg < 8; ++rg)
          for (int q = 0; q < N / 64; ++q)
            wg::bulk_load(s.d[stage] + rg * N * 8 + q * 512,
                          src + (long)q * kBlk + rg * 512, 1024,
                          &s.full[stage]);
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
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  int stage = 0, pend = -1;
  uint32_t phase = 0;
  for (long kb = kb0; kb < kb1; ++kb) {
    wg::mbar_wait(&s.full[stage], phase);
    wg::mma_fence();
    // MN-major: A's 8-row (K) groups 1024 bytes apart, its core matrices
    // along M 128 apart; D's 8-row groups N·16 apart
    const uint32_t aa = wg::smem_addr(s.a[stage][g]);
    const uint32_t da = wg::smem_addr(s.d[stage]);
#pragma unroll
    for (int ks = 0; ks < 64; ks += 16)
      wg::mma_mn<N>(acc, wg::desc_mn(aa + (ks >> 3) * 1024, 1024, 128),
                    wg::desc_mn(da + (ks >> 3) * N * 16, N * 16, 128));
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
  float* dst = a.part + (long)blockIdx.y * a.slab + p.out;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int m = mt * 128 + 64 * g + 16 * ww + (lane >> 2) +
                  8 * ((i >> 1) & 1);
    const int c = ntile * N + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    if (m < p.m) dst[(long)m * p.n_cols + c] = acc[i];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    wgrad_kernel(const __grid_constant__ WgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WgradSmem& s = *reinterpret_cast<WgradSmem*>(smem_raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      wg::mbar_init(&s.full[i], 1);
      wg::mbar_init(&s.empty[i], kConsumerWarps);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  const int pi = (a.n_prod > 1 && (int)blockIdx.x >= a.p[1].tile0) ? 1 : 0;
  const WProd& p = a.p[pi];
  const int t = (int)blockIdx.x - p.tile0;
  const int mt = t / p.tiles_n, ntile = t % p.tiles_n;
  if (p.tile_n == 128)
    wgrad_tile<128>(a, p, mt, ntile, s);
  else
    wgrad_tile<256>(a, p, mt, ntile, s);
}

struct HeadBwdArgs {
  const bf16* v;         // the kept view layer, (n/64, 2) blocks
  const float* rgb;      // (n, 3) the kept rgb
  const float* g_rgb;    // (n, 3)
  const float* wrgb;     // (128 × 3) the rgb head
  const bf16* wvbt;      // W_vbᵀ: two 64 × 256 slices
  bf16* dzv;             // (n/64, 2) blocks
  bf16* dbn;             // (n/64, 4) blocks
  float* d_dir;          // (n / spr, 128)
  float* hpart;          // (gridDim, 2, kHeadPart)
  int n, spr;
};

struct __align__(128) HeadBwdSmem {
  bf16 b[2][kSliceN];
  bf16 t[2][64 * kView];
  float wrgb[3 * kView];
};

__global__ void __launch_bounds__(256, 1)
    head_bwd_kernel(const __grid_constant__ HeadBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  HeadBwdSmem& s = *reinterpret_cast<HeadBwdSmem*>(smem_raw);
  const int g = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int ww = tw >> 5, lane = threadIdx.x & 31;
  const int rA = 16 * ww + (lane >> 2), cA = 2 * (lane & 3);
  {
    const uint4* src = reinterpret_cast<const uint4*>(a.wvbt);
    uint4* dst = reinterpret_cast<uint4*>(&s.b[0][0]);
    for (int i = threadIdx.x; i < 2 * kSliceN / 8; i += blockDim.x)
      dst[i] = src[i];
  }
  for (int i = threadIdx.x; i < 3 * kView; i += blockDim.x)
    s.wrgb[i] = a.wrgb[i];
  wg::fence_async_smem();
  __syncthreads();
  const int c = tw;              // this thread's view column
  const float k = 1.0f + 2.0f * kRgbPad;
  float w_c[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) w_c[q] = s.wrgb[c * 3 + q];
  float d_rgb[3] = {0.0f, 0.0f, 0.0f}, d_bview = 0.0f, d_brgb = 0.0f;
  bf16* T = s.t[g];
  for (long mt = blockIdx.x; mt < a.n / 128; mt += gridDim.x) {
    const long rb = 2 * mt + g;
    const bf16* vb = a.v + (rb * 2 + (c >> 6)) * kBlk;
    bf16* zb = a.dzv + (rb * 2 + (c >> 6)) * kBlk;
    float dir = 0.0f;
    for (int r = 0; r < 64; ++r) {
      const long row = rb * 64 + r;
      float dl[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float sg = (a.rgb[row * 3 + q] + kRgbPad) / k;
        dl[q] = a.g_rgb[row * 3 + q] * k * sg * (1.0f - sg);
      }
      const float v = bf(*reinterpret_cast<const bf16*>(
          reinterpret_cast<const char*>(vb) + wg::cm_off(r, c & 63, 64)));
      const float dv = dl[0] * w_c[0] + dl[1] * w_c[1] + dl[2] * w_c[2];
      const bf16 z = v > 0.0f ? __float2bfloat16_rn(dv)
                              : __float2bfloat16_rn(0.0f);
      *reinterpret_cast<bf16*>(reinterpret_cast<char*>(T) +
                               wg::cm_off(r, c, kView)) = z;
      *reinterpret_cast<bf16*>(reinterpret_cast<char*>(zb) +
                               wg::cm_off(r, c & 63, 64)) = z;
#pragma unroll
      for (int q = 0; q < 3; ++q) d_rgb[q] += v * dl[q];
      d_bview += bf(z);
      dir += bf(z);
      if (c < 3) d_brgb += dl[c];
      if ((row + 1) % a.spr == 0) {
        a.d_dir[(row / a.spr) * kView + c] = dir;
        dir = 0.0f;
      }
    }
    wg::fence_async_smem();
    wg::wg_sync(1 + g);
    float acc[128];
    wg::mma_fence();
    wg::mma_slice<kTileN>(acc, wg::smem_addr(T), kView, 0,
                          wg::smem_addr(s.b[0]), 64, true);
    wg::mma_slice<kTileN>(acc, wg::smem_addr(T), kView, 64,
                          wg::smem_addr(s.b[1]), 64, false);
    wg::mma_commit();
    wg::mma_wait<0>();
    wg::fence_regs(acc);
    bf16* out = a.dbn + rb * (kBn / 64) * kBlk;
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
      const int col = 8 * j + cA;
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      bf16* blk = out + (col >> 6) * kBlk;
      st_pair(blk, rA, col & 63, lo);
      st_pair(blk, rA + 8, col & 63, hi);
    }
    wg::wg_sync(1 + g);   // the wgmmas are done with T
  }
  float* hp = a.hpart + ((long)blockIdx.x * 2 + g) * kHeadPart;
#pragma unroll
  for (int q = 0; q < 3; ++q) hp[c * 3 + q] = d_rgb[q];
  hp[3 * kView + c] = d_bview;
  if (c < 4) hp[4 * kView + c] = c < 3 ? d_brgb : 0.0f;
}

// out[i] = Σ_p part[p·stride + i] for i < m, p in order.
__global__ void sum_parts_kernel(const float* part, int n_part, long stride,
                                 long m, float* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float t = 0.0f;
  for (int p = 0; p < n_part; ++p) t += part[(long)p * stride + i];
  out[i] = t;
}

int sum_parts(const float* part, int n_part, long stride, long m, float* out,
              cudaStream_t st) {
  if (m <= 0) return 0;
  sum_parts_kernel<<<(int)((m + 255) / 256), 256, 0, st>>>(part, n_part,
                                                           stride, m, out);
  return (int)cudaGetLastError();
}

// Column sums of X ((n/64, C/64) blocks), each row weighted by w (or 1),
// into out (C): chunks of rows, about four CUDA blocks an SM, then their
// partials (in part) summed in order.
int colsum(const bf16* X, const float* w, int n, int C, int n_sm,
           float* part, float* out, cudaStream_t st) {
  const long n_rb = n / 64;
  long chunks = (4L * n_sm * 64 + C - 1) / C;
  if (chunks > n_rb) chunks = n_rb;
  if (chunks < 1) chunks = 1;
  const long per = (n_rb + chunks - 1) / chunks;
  chunks = (n_rb + per - 1) / per;
  colsum_kernel<<<dim3(C / 64, (int)chunks), 256, 0, st>>>(X, w, n, C, per,
                                                           part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_parts(part, (int)chunks, C, C, out, st);
}

// The split of the rows that fills the card best: n_split in [1, s_max]
// with the most units (tiles × n_split) a wave of n_sm, the fewest splits
// among equals.
int best_split(int tiles, int n_sm, long s_max) {
  int best = 1;
  double best_eff = -1.0;
  for (int sp = 1; sp <= s_max; ++sp) {
    const long units = (long)tiles * sp;
    const double eff =
        (double)units / (double)(((units + n_sm - 1) / n_sm) * n_sm);
    if (eff > best_eff + 1e-9) {
      best_eff = eff;
      best = sp;
    }
  }
  return best;
}

// The weight gradients of up to two products in one launch, then their
// partials summed into grad + out_off (the products' outputs lie there
// one after the other, as they lie in a partial).
int run_wgrad(WgradArgs& wa, int n_sm, float* wpart, long wpart_floats,
              float* grad_out, cudaStream_t st) {
  int tiles = 0;
  long slab = 0;
  for (int i = 0; i < wa.n_prod; ++i) {
    WProd& p = wa.p[i];
    p.tiles_m = (p.m + 127) / 128;
    p.tiles_n = p.n_cols / p.tile_n;
    p.tile0 = tiles;
    p.out = slab;
    tiles += p.tiles_m * p.tiles_n;
    slab += (long)p.m * p.n_cols;
  }
  long s_max = wpart_floats / slab;
  const long steps = wa.rows / 64;
  if (s_max > steps / 8) s_max = steps / 8;
  if (s_max < 1) s_max = 1;
  if (slab > wpart_floats) return (int)cudaErrorInvalidValue;
  const int n_split = best_split(tiles, n_sm, s_max);
  wa.rows_per_split = ((wa.rows + n_split - 1) / n_split + 63) / 64 * 64;
  wa.part = wpart;
  wa.slab = slab;
  wgrad_kernel<<<dim3(tiles, n_split), kThreads, sizeof(WgradSmem), st>>>(
      wa);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_parts(wpart, n_split, slab, slab, grad_out, st);
}

// The forward of fnt_wide_field and fnt_wide_field_train. hs: null (the
// trunk's activations ping-pong through h0 and h1), or every layer's
// output kept, layer i at hs + i·n·width, with its ReLU bits at masks +
// i·n·width/128 (uint4s); bn_out, v_out: the head's kept outputs (with hs
// and a view branch).
int wide_forward(const void* mean, const void* var, const void* dirpart,
                 const void* wp, const void* b, void* h0, void* h1,
                 bf16* hs, uint4* masks, void* a0, void* part, void* rgb,
                 void* sigma, bf16* bn_out, bf16* v_out, int n, int spr,
                 int L, int depth, int width, int skip_mask, int has_vd,
                 int device, cudaStream_t st) {
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
  auto out_of = [&](int i) {
    return hs ? hs + (long)i * n * width : bufs[i & 1];
  };
  const int nt = width / kTileN;
  for (int i = 0; i < depth; ++i) {
    const bool last = i == depth - 1;
    LayerArgs la;
    la.h_in = i > 0 ? out_of(i - 1) : nullptr;
    la.a_in = ipe_op;
    la.w = w + lay.w[i];
    la.bias = fb + lay.b[i];
    la.wsig = last ? fb + lay.sig : nullptr;
    la.b_sig = fb + lay.b_sig;
    la.out = out_of(i);
    la.part = static_cast<float*>(part);
    la.sigma = static_cast<float*>(sigma);
    la.n = n;
    la.W = width;
    la.kb_h = lay.kb_h[i];
    la.kb_a = lay.kb_a[i];
    la.direct = nt == 1 && !has_vd;
    la.mask = hs ? masks + (long)i * n * width / 128 : nullptr;
    const int code =
        hs ? launch(layer_kernel<true>, la, (int)sizeof(LayerSmem),
                    (n / 128) * nt, device, st)
           : launch(layer_kernel<false>, la, (int)sizeof(LayerSmem),
                    (n / 128) * nt, device, st);
    if (code) return code;
  }
  if (!has_vd) return 0;
  HeadArgs ha;
  ha.h_in = out_of(depth - 1);
  ha.w_bn = w + lay.bn;
  ha.dirpart = static_cast<const float*>(dirpart);
  ha.b = fb;
  ha.part = static_cast<const float*>(part);
  ha.rgb = static_cast<float*>(rgb);
  ha.sigma = static_cast<float*>(sigma);
  ha.bn_out = bn_out;
  ha.v_out = v_out;
  ha.n = n;
  ha.W = width;
  ha.spr = spr;
  ha.lay = lay;
  if (hs)
    return launch(head_kernel<true>, ha, (int)sizeof(HeadSmem), n / 128,
                  device, st);
  return launch(head_kernel<false>, ha, (int)sizeof(HeadSmem), n / 128,
                device, st);
}

bool bad_shape(int n, int spr, int L, int depth, int width, int skip_mask) {
  return n < 0 || n % 128 || spr < 1 || n % spr || L < 1 ||
         6 * L > kIpeCols || !(width == 256 || width == 1024) || depth < 1 ||
         depth > kMaxDepthW || (skip_mask & 1) || (skip_mask >> depth) ||
         __builtin_popcount(skip_mask) > 1;
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
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
  if (bad_shape(n, spr, L, depth, width, skip_mask) ||
      (has_vd && dirpart == nullptr) || misaligned(wp) || misaligned(h0) ||
      misaligned(h1) || misaligned(a0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return wide_forward(mean, var, dirpart, wp, b, h0, h1, nullptr, nullptr,
                      a0, part, rgb, sigma, nullptr, nullptr, n, spr, L,
                      depth, width, skip_mask, has_vd, device,
                      static_cast<cudaStream_t>(stream));
}

// The training forward: fnt_wide_field with every trunk layer's bf16
// output kept in hs ((depth, n, width), the activation layout) and its
// ReLU bits in masks ((depth, n · width / 8) bytes), the IPE operand in
// a0, and with has_vd the bottleneck in bn ((n, 256)) and the view layer
// in v ((n, 128)), for fnt_wide_field_backward.
int fnt_wide_field_train(const void* mean, const void* var,
                         const void* dirpart, const void* wp, const void* b,
                         void* hs, void* masks, void* a0, void* part,
                         void* rgb, void* sigma, void* bn, void* v, int n,
                         int spr, int L, int depth, int width, int skip_mask,
                         int has_vd, int device, void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  if (bad_shape(n, spr, L, depth, width, skip_mask) ||
      (has_vd && (!dirpart || !bn || !v || misaligned(bn) || misaligned(v))) ||
      misaligned(wp) || misaligned(hs) || misaligned(masks) ||
      misaligned(a0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return wide_forward(mean, var, dirpart, wp, b, nullptr, nullptr,
                      static_cast<bf16*>(hs), static_cast<uint4*>(masks), a0,
                      part, rgb, sigma, static_cast<bf16*>(bn),
                      static_cast<bf16*>(v), n, spr, L, depth, width,
                      skip_mask, has_vd, device,
                      static_cast<cudaStream_t>(stream));
}

// K7's training backward: the cotangents g_rgb ((n, 3) f32, with has_vd)
// and g_sigma ((n) f32) through the net whose fnt_wide_field_train kept
// a0, hs, masks, bn, v and rgb → the weight and bias gradients in grad (f32) at
// the host offsets offs: one block a trunk layer ((W if i > 0) + (128 if
// the layer takes the IPE operand) rows × W, the h rows first), the
// bottleneck (W × 256), the view layer (256 × 128); then each layer's
// bias (W), the σ head (W), the bottleneck's bias (256), the view bias
// (128), the rgb head (128 × 3) and its bias (3). d_dir: (n / spr, 128)
// the per-ray view term's cotangent (64 % spr == 0). wpt: the transposed
// slices (kernels/widefield.py::_bwd_buffers); b: the forward's f32
// buffer. Workspaces: dz (2 · n · W bf16), dbn (n · 256), dzv (n · 128),
// cpart (n_sm · (2 · max(W, 256) + 2 · kHeadPart) f32), wpart
// (wpart_floats f32). Returns a cudaError_t.
int fnt_wide_field_backward(const void* a0, const void* hs,
                            const void* masks, const void* bn,
                            const void* v, const void* rgb, const void* g_rgb,
                            const void* g_sigma, const void* wpt,
                            const void* b, void* dz, void* dbn, void* dzv,
                            void* cpart, void* wpart, long wpart_floats,
                            void* grad, const void* offs, void* d_dir, int n,
                            int spr, int depth, int width, int skip_mask,
                            int has_vd, int device, void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  if (bad_shape(n, spr, 1, depth, width, skip_mask) ||
      (has_vd && (!bn || !v || !rgb || !g_rgb || !dbn || !dzv || !d_dir ||
                  64 % spr)) ||
      misaligned(wpt) || misaligned(dz))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WideLayout lay = make_wide_layout(depth, width, skip_mask, has_vd);
  const long* off = static_cast<const long*>(offs);
  const int W = width, D = depth, nt = W / kTileN;
  const long nW = (long)n * W;
  const bf16* H = static_cast<const bf16*>(hs);
  const bf16* A0 = static_cast<const bf16*>(a0);
  const uint4* MK = static_cast<const uint4*>(masks);
  const long nW128 = nW / 128;   // uint4s of a layer's ReLU bits
  const bf16* WT = static_cast<const bf16*>(wpt);
  const float* fb = static_cast<const float*>(b);
  float* gr = static_cast<float*>(grad);
  float* cp = static_cast<float*>(cpart);
  float* wp = static_cast<float*>(wpart);
  bf16* dzs[2] = {static_cast<bf16*>(dz), static_cast<bf16*>(dz) + nW};
  int n_sm = 0;
  cudaError_t e = sm_count(device, &n_sm);
  if (e != cudaSuccess) return (int)e;
  int code = (int)set_smem((const void*)dgrad_kernel, device,
                           (int)sizeof(DgradSmem));
  if (code) return code;
  code = (int)set_smem((const void*)wgrad_kernel, device,
                       (int)sizeof(WgradSmem));
  if (code) return code;
  // offsets: D weight blocks, bottleneck, view, D biases, then σ head,
  // bottleneck bias, view bias, rgb head, rgb bias
  const long* o_b = off + D + 2;
  const long* o_v = off + 2 * D + 2;
  const long wt_bn = (long)(D - 1) * W * W;
  const long wt_vb = wt_bn + (long)kBn * W;
  const int grid_rows = (n / 128) * nt < n_sm ? (n / 128) * nt : n_sm;
  float* hpart = cp + (long)n_sm * 2 * (W > kBn ? W : kBn);

  if (has_vd) {
    code = (int)set_smem((const void*)head_bwd_kernel, device,
                         (int)sizeof(HeadBwdSmem));
    if (code) return code;
    HeadBwdArgs ha;
    ha.v = static_cast<const bf16*>(v);
    ha.rgb = static_cast<const float*>(rgb);
    ha.g_rgb = static_cast<const float*>(g_rgb);
    ha.wrgb = fb + lay.rgb;
    ha.wvbt = WT + wt_vb;
    ha.dzv = static_cast<bf16*>(dzv);
    ha.dbn = static_cast<bf16*>(dbn);
    ha.d_dir = static_cast<float*>(d_dir);
    ha.hpart = hpart;
    ha.n = n;
    ha.spr = spr;
    const int grid = n / 128 < n_sm ? n / 128 : n_sm;
    head_bwd_kernel<<<grid, 256, sizeof(HeadBwdSmem), st>>>(ha);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if ((code = sum_parts(hpart, 2 * grid, kHeadPart, 3 * kView,
                          gr + o_v[3], st)))
      return code;
    if ((code = sum_parts(hpart + 3 * kView, 2 * grid, kHeadPart, kView,
                          gr + o_v[2], st)))
      return code;
    if ((code = sum_parts(hpart + 4 * kView, 2 * grid, kHeadPart, 3,
                          gr + o_v[4], st)))
      return code;
    if ((code = colsum(static_cast<const bf16*>(dbn), nullptr, n, kBn, n_sm,
                       cp, gr + o_v[1], st)))
      return code;
    // the bottleneck's and the view layer's weight gradients
    WgradArgs wa{};
    wa.n_prod = 2;
    wa.rows = n;
    wa.p[0] = WProd{H + (D - 1) * nW, static_cast<const bf16*>(dbn), 0,
                    W / 64, kBn / 64, W, kBn, kTileN, 0, 0, 0};
    wa.p[1] = WProd{static_cast<const bf16*>(bn),
                    static_cast<const bf16*>(dzv), 0, kBn / 64, kView / 64,
                    kBn, kView, kView, 0, 0, 0};
    if ((code = run_wgrad(wa, n_sm, wp, wpart_floats, gr + off[D], st)))
      return code;
  }
  // the σ head's weight gradient: the last layer's output weighted by gσ
  if ((code = colsum(H + (D - 1) * nW, static_cast<const float*>(g_sigma), n,
                     W, n_sm, cp, gr + o_v[0], st)))
    return code;
  // the last trunk layer's cotangent: from the bottleneck's (none in the
  // proposal) and σ's
  DgradArgs da;
  da.a_in = has_vd ? static_cast<const bf16*>(dbn) : nullptr;
  da.w = WT + wt_bn;
  da.mask = MK + (D - 1) * nW128;
  da.g_sigma = static_cast<const float*>(g_sigma);
  da.wsig = fb + lay.sig;
  da.out = dzs[(D - 1) & 1];
  da.n = n;
  da.W = W;
  da.kb = has_vd ? kBn / 64 : 0;
  dgrad_kernel<<<grid_rows, kThreads, sizeof(DgradSmem), st>>>(da);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int i = D - 1; i >= 0; --i) {
    const bf16* dzi = dzs[i & 1];
    if ((code = colsum(dzi, nullptr, n, W, n_sm, cp, gr + o_b[i], st)))
      return code;
    WgradArgs wa{};
    wa.rows = n;
    int np = 0;
    if (i > 0)
      wa.p[np++] = WProd{H + (long)(i - 1) * nW, dzi, 0, W / 64, W / 64, W,
                         W, kTileN, 0, 0, 0};
    if (lay.kb_a[i])
      wa.p[np++] = WProd{A0, dzi, 0, kIpeCols / 64, W / 64, kIpeCols, W,
                         kTileN, 0, 0, 0};
    wa.n_prod = np;
    if ((code = run_wgrad(wa, n_sm, wp, wpart_floats, gr + off[i], st)))
      return code;
    if (i == 0) break;
    DgradArgs dg;
    dg.a_in = dzi;
    dg.w = WT + (long)(i - 1) * W * W;
    dg.mask = MK + (long)(i - 1) * nW128;
    dg.g_sigma = nullptr;
    dg.wsig = nullptr;
    dg.out = dzs[(i - 1) & 1];
    dg.n = n;
    dg.W = W;
    dg.kb = W / 64;
    dgrad_kernel<<<grid_rows, kThreads, sizeof(DgradSmem), st>>>(dg);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
}  // extern "C"
