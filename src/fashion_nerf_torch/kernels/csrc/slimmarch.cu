// Multi-block march (kernel K2), one sample block per launch: the 8x256
// fine field with its view branch (and the 128-wide fine field), and nets
// without one (the σ-only proposal nets of the generic proposal march and
// of the σ march above width 128).
//
// Replaces: src/fashion_nerf/kernels/slimmarch_pallas.py::_slim_kernel (via
// _slim_eval), the TPU kernel that marches the fine field over NB blocks of
// SB samples per ray with the transmittance carry and the rgb accumulator
// held in VMEM across a tile's sequential block programs.
//
// What bounds it on the H100: bf16 matrix products, 590,464 MACs per row
// (8 trunk layers, the feature and view layers) against ~0.5 KB of per-row
// input, so the tensor cores; next, the L2 → shared-memory traffic of the
// 1.18 MB of weights, which every CUDA block streams once per work item.
//
// Design (csrc/wg_trunk.cuh holds the shared pieces):
// - Persistent CUDA blocks, one per SM, each of two consumer warpgroups and
//   one producer warpgroup (one lane of it issues the copies; setmaxnreg
//   hands the producer's registers to the consumers). A work item is 128
//   rows (ray-major rows of sample block b, 64 per warpgroup); the
//   predication tile of tile_rows/SB rays holds tile_rows/128 items
//   (tile_rows 2048, or 1024 for a conditioned net, whose cond is folded
//   into oX). Every block lists the launch's live tiles itself (the same
//   list in every block) and strides over their items; the owner block of
//   a dead tile writes its w = 0 and carries rgb and logT through.
// - Layers on wgmma m64n256k16 (m64n128k16 for the view layer): A is the
//   warpgroup's activation tile in shared memory, B a weight slice, the
//   64×256 f32 accumulator 128 registers a thread.
// - Weights through a ring of 3 slices of 64×256 bf16 in shared memory: the
//   producer streams the net's slices (kernels/wgpack.py packs them
//   once per net) with cp.async.bulk behind full/empty mbarriers, 128 rows
//   per fetched slice, half the L2 traffic of a 64-row slab.
// - The epilogue of each layer runs in registers and writes the layer's
//   output in place over the warpgroup's own activation tile: bias, the
//   hoisted x-term oX + dX·t of each layer that takes positions (the first
//   and every skip layer, as the reference hoists them; their (oX, dX)
//   columns are W apart, in layer order), with __fmul_rn/__fadd_rn as the
//   plain version rounds, relu, bf16. The σ
//   head (256→1) rides the last trunk epilogue and the rgb head (128→3) the
//   view epilogue, as register dot products reduced over the 4 lanes of a
//   row.
// - A net without a view branch (the reference's has_vd=False plan,
//   slimmarch_pallas.py:113-116, :245-246) takes the 4-wide out head in the
//   last trunk epilogue (rgb = sigmoid of lanes 0-2, σ lane 3) and has no
//   feature or view layer and no dirpart operand; instantiated for widths
//   128 (the proposal net) and 256. The x-layers are those the net has:
//   one without a skip layer.
// - Four instantiations: width 256 and 128, each with and without the view
//   branch. The 128-wide field with a view branch takes the view layer at
//   N = 64 (m64n64k16).
// - Compositing by warps: one warp per ray (SB = 32; a lane per sample) or
//   per 32/SB rays (SB < 32, segments of SB lanes), two samples a lane at
//   SB = 64: the exclusive log(1−α) prefix is a shuffle scan with the
//   carried logT.
// - Every SB the reference takes (wg::march_sb_ok: powers of two to 512,
//   to 256 at the conditioned tile). Below 16 a warpgroup's 64 rows hold
//   more rays than the per-ray hoists staged in shared memory, so the
//   epilogues read them from device memory (L2). Above 64 a ray spans both
//   warpgroups, and above 128 several items: one CUDA block runs a ray's
//   items in order (wg::unit_row0), and after each item warp 0 composites
//   its 128 samples, the carry and the rgb sums held in its registers from
//   item to item.
// The launch reads logT_in, written by the previous launch, and writes
// logT_out, a separate buffer: no block reads a carry that another block
// of the same launch is updating.
#include "fnt_common.cuh"
#include "wg_trunk.cuh"

namespace fnt {
namespace {

constexpr int kStages = 3;                   // weight ring slices
constexpr int kConsumers = 2 * 128;           // two warpgroups
constexpr int kThreadsK2 = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxTilesK2 = 1024;
constexpr int kMaxRaysWg = wg::kWgRows / 16;  // rays staged a warpgroup
constexpr int kMaxSlices = 96;

template <int W>
struct __align__(128) SlimSmem {
  bf16 h[2][wg::kWgRows * W];            // activations per warpgroup
  bf16 a0[2][wg::kWgRows * kMaxK0];      // posenc operand per warpgroup
  bf16 ring[kStages][wg::kSliceK * W];   // weight slices
  // per-ray inputs of a warpgroup's rays, staged once per item: the
  // phases (oF, dF), the current x-layer's (oX, dX) and the view term
  float ph[2][kMaxRaysWg][2][kMaxK0];
  float xs[2][kMaxRaysWg][2][W];
  bf16 dirs[2][kMaxRaysWg][W / 2];
  // the σ head (W) then the rgb head (W/2 × 3), or the out head (W × 4)
  float heads[W * 4];
  float row_t[wg::kItemRows];
  float row_sigma[wg::kItemRows];
  float row_rgb[wg::kItemRows][3];
  float long_run[4];   // a long ray's log-T carry and rgb sums
  uint64_t full[kStages];
  uint64_t empty[kStages];
  int n_live;
  uint8_t tile_live[kMaxTilesK2];
  uint16_t live[kMaxTilesK2];
  // the net's biases follow (SlimArgs::n_b floats)
};

struct SlimArgs {
  const float* hit;        // (R,) AABB hit flags
  const float* block_hit;  // (R, NB) macro-box flags per sample block
  const float* oX;         // (R, n_x·W) x-layer intercepts (bias folded)
  const float* dX;         // (R, n_x·W) x-layer slopes
  const float* oF;         // (R, 6L) phase intercepts (π/2 folded)
  const float* dF;         // (R, 6L) phase slopes
  const bf16* dirpart;     // (R, W/2) per-ray view term (view branch only)
  const float* t;          // (R, NB·SB) sample positions
  const float* d;          // (R, NB·SB) scaled interval widths
  const bf16* w;           // packed weights (Layout): the heads
  const bf16* wp;          // march slices (kernels/wgpack.py)
  const float* b;          // packed biases (x-layer biases are 0: hoisted)
  float* rgb;              // (R, 3) accumulated radiance
  float* w_out;            // (R, NB·SB) weights
  const float* logT_in;    // (R,) carry before block b (unused at b = 0)
  float* logT_out;         // (R,) carry after block b
  int R, NB, SB, blk, L, softplus, n_b;
  int tile_rows;           // rows of a predication tile: 2048, 1024 when
                           // the net is conditioned (as the reference)
  float log_eps;
  int n_slices;
  int slice_bytes[kMaxSlices];
  Layout lay;
};

// The consumers' position in the weight ring: the slice to wait for next,
// and the slice whose wgmmas may still run (released after the next one).
struct RingPos {
  int stage;
  uint32_t phase;
  int pend;
};

template <class Smem>
__device__ __forceinline__ void release(Smem& s, int stage) {
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&s.empty[stage]);
}

// acc (+)= A·(the next weight slice of kk rows), A at column a_k of the
// tile at a_addr (a_K columns). Keeps one slice's wgmmas in flight.
template <int N, class Smem>
__device__ __forceinline__ void consume(float (&acc)[N / 2], RingPos& rp,
                                        Smem& s, uint32_t a_addr,
                                        int a_K, int a_k, int kk,
                                        bool zero) {
  wg::mbar_wait(&s.full[rp.stage], rp.phase);
  wg::mma_fence();
  wg::mma_slice<N>(acc, a_addr, a_K, a_k, wg::smem_addr(s.ring[rp.stage]),
                   kk, zero);
  wg::mma_commit();
  if (rp.pend >= 0) {
    wg::mma_wait<1>();
    release(s, rp.pend);
  }
  rp.pend = rp.stage;
  if (++rp.stage == kStages) {
    rp.stage = 0;
    rp.phase ^= 1u;
  }
}

template <int R, class Smem>
__device__ __forceinline__ void drain(float (&acc)[R], RingPos& rp,
                                      Smem& s) {
  wg::mma_wait<0>();
  wg::fence_regs(acc);
  release(s, rp.pend);
  rp.pend = -1;
}

__device__ __forceinline__ void st_pair(bf16* tile, int r, int c, int K,
                                        float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(tile) +
                                     wg::cm_off(r, c, K)) =
      __floats2bfloat162_rn(v0, v1);
}

template <int W, bool kVd>
__global__ void __launch_bounds__(kThreadsK2, 1)
    slim_march_kernel(const __grid_constant__ SlimArgs a) {
  constexpr int kW = W, kHalf = W / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SlimSmem<W>& s = *reinterpret_cast<SlimSmem<W>*>(smem_raw);
  float* bias = reinterpret_cast<float*>(smem_raw + sizeof(SlimSmem<W>));
  const Layout& lay = a.lay;
  const int SB = a.SB, S = a.NB * a.SB;
  const int rpt = a.tile_rows / SB;
  const bool first = a.blk == 0;
  const long col0 = (long)a.blk * SB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(&s.full[i], 1);
      wg::mbar_init(&s.empty[i], kConsumers / 32);
    }
    wg::mbar_init_fence();
  }
  // shared memory leaves little L1: everything the epilogues read is
  // staged here, the net's biases and heads once per block
  for (int i = threadIdx.x; i < a.n_b; i += blockDim.x) bias[i] = a.b[i];
  if (kVd) {
    for (int i = threadIdx.x; i < kW; i += blockDim.x)
      s.heads[i] = bf(a.w[lay.w_sig + i]);
    for (int i = threadIdx.x; i < kHalf * 3; i += blockDim.x)
      s.heads[kW + i] = bf(a.w[lay.w_rgb + i]);
  } else {
    for (int i = threadIdx.x; i < kW * 4; i += blockDim.x)
      s.heads[i] = bf(a.w[lay.w_out + i]);
  }
  const int n_live = wg::live_tiles(
      a.R / rpt, rpt, s.tile_live, s.live, &s.n_live,
      [&](long ray) {
        const float lt = first ? 0.0f : a.logT_in[ray];
        return a.hit[ray] > 0.0f && a.block_hit[ray * a.NB + a.blk] > 0.0f &&
               lt > a.log_eps;
      },
      [&](int tile, int ln) {
        const long ray0 = (long)tile * rpt;
        for (int i = ln; i < rpt * SB; i += 32)
          a.w_out[(ray0 + i / SB) * S + col0 + i % SB] = 0.0f;
        for (int i = ln; i < rpt; i += 32) {
          const long ray = ray0 + i;
          a.logT_out[ray] = first ? 0.0f : a.logT_in[ray];
          if (first)
            for (int c = 0; c < 3; ++c) a.rgb[ray * 3 + c] = 0.0f;
        }
      });
  const int n_units = n_live * (a.tile_rows / wg::unit_rows(SB));
  const int ipu = wg::unit_items(SB);

  if (warp >= kConsumers / 32) {
    // producer warpgroup: one lane streams the net's slices for every item
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumers / 32 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x)
      for (int k = 0; k < ipu; ++k) {
        const char* src = reinterpret_cast<const char*>(a.wp);
        for (int sl = 0; sl < a.n_slices; ++sl) {
          const int bytes = a.slice_bytes[sl];
          wg::mbar_wait(&s.empty[stage], phase ^ 1u);
          wg::mbar_expect_tx(&s.full[stage], bytes);
          wg::bulk_load(s.ring[stage], src, bytes, &s.full[stage]);
          src += bytes;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows [64g, 64g + 64) of each item
  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, tw = threadIdx.x & 127, ww = tw >> 5;
  const int bar = 1 + g;
  bf16* H = s.h[g];
  bf16* A0 = s.a0[g];
  const uint32_t h_addr = wg::smem_addr(H), a0_addr = wg::smem_addr(A0);
  float(*ph)[2][kMaxK0] = s.ph[g];
  float(*xs)[2][kW] = s.xs[g];
  bf16(*dirs)[kHalf] = s.dirs[g];
  // rays of the warpgroup's rows; their hoists staged, or read from L2
  const int nr = SB < wg::kWgRows ? wg::kWgRows / SB : 1;
  const bool staged = nr <= kMaxRaysWg;
  float* row_t = s.row_t + 64 * g;
  float* row_sigma = s.row_sigma + 64 * g;
  float(*row_rgb)[3] = s.row_rgb + 64 * g;
  const int k0 = lay.k0, n_ph = 6 * a.L;
  int n_x = 0;   // layers that take positions: oX / dX hold n_x·W columns
  for (int i = 0; i < lay.depth; ++i) n_x += lay.w_a0[i] >= 0;
  const int xw = n_x * kW;   // row stride of oX / dX
  // this thread's accumulator rows rA, rA + 8 and first column pair
  const int rA = 16 * ww + (lane >> 2), cA = 2 * (lane & 3);
  RingPos rp{0, 0u, -1};
  float acc[kW / 2];
  float(&acc_v)[kHalf / 2] = *reinterpret_cast<float(*)[kHalf / 2]>(acc);

  for (int u = blockIdx.x; u < n_units; u += gridDim.x)
  for (int k = 0; k < ipu; ++k) {
    const long row0 = wg::unit_row0(s.live, u, k, g, a.tile_rows, SB);
    const long ray0 = row0 / SB;   // first ray of the warpgroup
    if (tw < 64)
      row_t[tw] = SB <= wg::kWgRows
                      ? a.t[(ray0 + tw / SB) * S + col0 + tw % SB]
                      : a.t[ray0 * S + col0 + row0 % SB + tw];
    if (staged) {
      for (int i = tw; i < nr * 2 * n_ph; i += 128) {
        const int r = i / (2 * n_ph), which = (i / n_ph) & 1, c = i % n_ph;
        ph[r][which][c] = (which ? a.dF : a.oF)[(ray0 + r) * n_ph + c];
      }
      if (kVd)
        for (int i = tw; i < nr * kHalf; i += 128)
          dirs[i / kHalf][i % kHalf] = a.dirpart[ray0 * kHalf + i];
    }
    wg::wg_sync(bar);
    // posenc operand: 32 lanes fill one core matrix per step; the phases
    // staged in shared memory, or (few rays) read from device memory
    auto posenc = [&](auto from_smem) {
      for (int i = tw; i < 32 * k0; i += 128) {
        const int cm = i >> 5;
        const int r = (cm & 7) * 8 + ((i & 31) >> 2);
        const int c = (cm >> 3) * 8 + (i & 3) * 2;
        float v0 = 0.0f, v1 = 0.0f;
        if constexpr (decltype(from_smem)::value) {
          const float(*p)[kMaxK0] = ph[r / SB];
          if (c < n_ph)
            v0 = sinf(__fadd_rn(p[0][c], __fmul_rn(p[1][c], row_t[r])));
          if (c + 1 < n_ph)
            v1 = sinf(__fadd_rn(p[0][c + 1], __fmul_rn(p[1][c + 1], row_t[r])));
        } else {
          const float* p0 = a.oF + (ray0 + r / SB) * n_ph;
          const float* p1 = a.dF + (ray0 + r / SB) * n_ph;
          if (c < n_ph)
            v0 = sinf(__fadd_rn(__ldg(p0 + c), __fmul_rn(__ldg(p1 + c),
                                                         row_t[r])));
          if (c + 1 < n_ph)
            v1 = sinf(__fadd_rn(__ldg(p0 + c + 1),
                                __fmul_rn(__ldg(p1 + c + 1), row_t[r])));
        }
        st_pair(A0, r, c, k0, v0, v1);
      }
    };
    if (staged)
      posenc(std::true_type{});
    else
      posenc(std::false_type{});
    wg::fence_async_smem();
    wg::wg_sync(bar);

    // rays of rows rA and rA + 8 (one ray at SB ≥ 16)
    const int rl_lo = rA / SB, rl_hi = (rA + 8) / SB;
    const float t_lo = row_t[rA], t_hi = row_t[rA + 8];
    int xl = 0;
    for (int i = 0; i < lay.depth; ++i) {
      const bool xlayer = lay.w_a0[i] >= 0, last = i == lay.depth - 1;
      if (xlayer && staged)   // read after the wg_sync below
        for (int j = tw; j < nr * 2 * kW; j += 128) {
          const int r = j / (2 * kW), which = (j / kW) & 1, c = j % kW;
          xs[r][which][c] = (which ? a.dX : a.oX)[(ray0 + r) * xw + xl * kW +
                                                  c];
        }
      bool zero = true;
      if (lay.w_h[i] >= 0)
        for (int k = 0; k < kW; k += wg::kSliceK) {
          consume<kW>(acc, rp, s, h_addr, kW, k, wg::kSliceK, zero);
          zero = false;
        }
      if (lay.w_a0[i] >= 0) consume<kW>(acc, rp, s, a0_addr, k0, 0, k0, zero);
      drain(acc, rp, s);
      wg::wg_sync(bar);   // the whole warpgroup is done reading H
      const float* bl = bias + lay.b[i];
      const float* ox = xs[staged ? rl_lo : 0][0];
      const float* dx = xs[staged ? rl_lo : 0][1];
      // without staging (few rays), the rows' x-layer columns in oX / dX
      const long xo = (long)xl * kW;
      const float* gox_lo = a.oX + (ray0 + rl_lo) * xw + xo;
      const float* gdx_lo = a.dX + (ray0 + rl_lo) * xw + xo;
      const float* gox_hi = a.oX + (ray0 + rl_hi) * xw + xo;
      const float* gdx_hi = a.dX + (ray0 + rl_hi) * xw + xo;
      // the σ head (lane 3), or the out head's four lanes
      float hd_lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float hd_hi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      auto epilogue = [&](auto from_smem) {
#pragma unroll
      for (int j = 0; j < kW / 8; ++j) {
        const int c = 8 * j + cA;
        const float b0 = bl[c], b1 = bl[c + 1];
        float v[4] = {__fadd_rn(acc[4 * j], b0), __fadd_rn(acc[4 * j + 1], b1),
                      __fadd_rn(acc[4 * j + 2], b0),
                      __fadd_rn(acc[4 * j + 3], b1)};
        if (xlayer) {
          if constexpr (decltype(from_smem)::value) {
            const float o0 = ox[c], o1 = ox[c + 1], d0 = dx[c], d1 = dx[c + 1];
            v[0] = __fadd_rn(v[0], __fadd_rn(o0, __fmul_rn(d0, t_lo)));
            v[1] = __fadd_rn(v[1], __fadd_rn(o1, __fmul_rn(d1, t_lo)));
            v[2] = __fadd_rn(v[2], __fadd_rn(o0, __fmul_rn(d0, t_hi)));
            v[3] = __fadd_rn(v[3], __fadd_rn(o1, __fmul_rn(d1, t_hi)));
          } else {
            v[0] = __fadd_rn(v[0], __fadd_rn(__ldg(gox_lo + c),
                                              __fmul_rn(__ldg(gdx_lo + c),
                                                        t_lo)));
            v[1] = __fadd_rn(v[1], __fadd_rn(__ldg(gox_lo + c + 1),
                                              __fmul_rn(__ldg(gdx_lo + c + 1),
                                                        t_lo)));
            v[2] = __fadd_rn(v[2], __fadd_rn(__ldg(gox_hi + c),
                                              __fmul_rn(__ldg(gdx_hi + c),
                                                        t_hi)));
            v[3] = __fadd_rn(v[3], __fadd_rn(__ldg(gox_hi + c + 1),
                                              __fmul_rn(__ldg(gdx_hi + c + 1),
                                                        t_hi)));
          }
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf(v[0], 0.0f),
                                                        fmaxf(v[1], 0.0f));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(fmaxf(v[2], 0.0f),
                                                        fmaxf(v[3], 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(H) +
                                           wg::cm_off(rA, c, kW)) = lo;
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(H) +
                                           wg::cm_off(rA + 8, c, kW)) = hi;
        if (last) {
          const float v0 = __low2float(lo), v1 = __high2float(lo);
          const float v2 = __low2float(hi), v3 = __high2float(hi);
          if (kVd) {
            const float s0 = s.heads[c], s1 = s.heads[c + 1];
            hd_lo[3] = fmaf(v0, s0, fmaf(v1, s1, hd_lo[3]));
            hd_hi[3] = fmaf(v2, s0, fmaf(v3, s1, hd_hi[3]));
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float w0 = s.heads[c * 4 + q];
              const float w1 = s.heads[(c + 1) * 4 + q];
              hd_lo[q] = fmaf(v0, w0, fmaf(v1, w1, hd_lo[q]));
              hd_hi[q] = fmaf(v2, w0, fmaf(v3, w1, hd_hi[q]));
            }
          }
        }
      }
      };
      if (staged)
        epilogue(std::true_type{});
      else
        epilogue(std::false_type{});
      xl += xlayer;
      if (last) {
#pragma unroll
        for (int q = kVd ? 3 : 0; q < 4; ++q) {
          hd_lo[q] += __shfl_xor_sync(0xffffffffu, hd_lo[q], 1);
          hd_lo[q] += __shfl_xor_sync(0xffffffffu, hd_lo[q], 2);
          hd_hi[q] += __shfl_xor_sync(0xffffffffu, hd_hi[q], 1);
          hd_hi[q] += __shfl_xor_sync(0xffffffffu, hd_hi[q], 2);
        }
        if ((lane & 3) == 0) {
          if (kVd) {
            row_sigma[rA] = hd_lo[3] + bias[lay.b_sig];
            row_sigma[rA + 8] = hd_hi[3] + bias[lay.b_sig];
          } else {
            for (int q = 0; q < 3; ++q) {
              row_rgb[rA][q] = sigmoidf(hd_lo[q] + bias[lay.b_out + q]);
              row_rgb[rA + 8][q] = sigmoidf(hd_hi[q] + bias[lay.b_out + q]);
            }
            row_sigma[rA] = hd_lo[3] + bias[lay.b_out + 3];
            row_sigma[rA + 8] = hd_hi[3] + bias[lay.b_out + 3];
          }
        }
      }
      wg::fence_async_smem();
      wg::wg_sync(bar);
    }

    // with a view branch, the feature and view layers (without one, the
    // out head rode the last trunk epilogue)
    if constexpr (kVd) {
      // feature layer: bf16(h·W_feat + b), no relu, in place
      for (int k = 0; k < kW; k += wg::kSliceK)
        consume<kW>(acc, rp, s, h_addr, kW, k, wg::kSliceK, k == 0);
      drain(acc, rp, s);
      wg::wg_sync(bar);
      {
        const float* bl = bias + lay.b_feat;
#pragma unroll
        for (int j = 0; j < kW / 8; ++j) {
          const int c = 8 * j + cA;
          const float b0 = bl[c], b1 = bl[c + 1];
          st_pair(H, rA, c, kW, __fadd_rn(acc[4 * j], b0),
                  __fadd_rn(acc[4 * j + 1], b1));
          st_pair(H, rA + 8, c, kW, __fadd_rn(acc[4 * j + 2], b0),
                  __fadd_rn(acc[4 * j + 3], b1));
        }
      }
      wg::fence_async_smem();
      wg::wg_sync(bar);

      // view layer (N = W/2) with the per-ray view term, then the rgb head
      for (int k = 0; k < kW; k += wg::kSliceK)
        consume<kHalf>(acc_v, rp, s, h_addr, kW, k, wg::kSliceK, k == 0);
      drain(acc_v, rp, s);
      {
        const float* bl = bias + lay.b_view;
        const bf16* dirp = dirs[staged ? rl_lo : 0];
        const bf16* gdir_lo = a.dirpart + (ray0 + rl_lo) * kHalf;
        const bf16* gdir_hi = a.dirpart + (ray0 + rl_hi) * kHalf;
        const float* wr = s.heads + kW;
        float c_lo[3] = {0.0f, 0.0f, 0.0f}, c_hi[3] = {0.0f, 0.0f, 0.0f};
        auto view = [&](auto from_smem) {
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j) {
          const int c = 8 * j + cA;
          const float2 bb = make_float2(bl[c], bl[c + 1]);
          float2 dl, dh;
          if constexpr (decltype(from_smem)::value) {
            dl = dh = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(dirp + c));
          } else {
            dl = __bfloat1622float2(__ldg(
                reinterpret_cast<const __nv_bfloat162*>(gdir_lo + c)));
            dh = __bfloat1622float2(__ldg(
                reinterpret_cast<const __nv_bfloat162*>(gdir_hi + c)));
          }
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              fmaxf(__fadd_rn(__fadd_rn(acc_v[4 * j], dl.x), bb.x), 0.0f),
              fmaxf(__fadd_rn(__fadd_rn(acc_v[4 * j + 1], dl.y), bb.y), 0.0f));
          const __nv_bfloat162 hi = __floats2bfloat162_rn(
              fmaxf(__fadd_rn(__fadd_rn(acc_v[4 * j + 2], dh.x), bb.x), 0.0f),
              fmaxf(__fadd_rn(__fadd_rn(acc_v[4 * j + 3], dh.y), bb.y), 0.0f));
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float w0 = wr[c * 3 + q], w1 = wr[(c + 1) * 3 + q];
            c_lo[q] = fmaf(__low2float(lo), w0,
                           fmaf(__high2float(lo), w1, c_lo[q]));
            c_hi[q] = fmaf(__low2float(hi), w0,
                           fmaf(__high2float(hi), w1, c_hi[q]));
          }
        }
        };
        if (staged)
          view(std::true_type{});
        else
          view(std::false_type{});
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          c_lo[q] += __shfl_xor_sync(0xffffffffu, c_lo[q], 1);
          c_lo[q] += __shfl_xor_sync(0xffffffffu, c_lo[q], 2);
          c_hi[q] += __shfl_xor_sync(0xffffffffu, c_hi[q], 1);
          c_hi[q] += __shfl_xor_sync(0xffffffffu, c_hi[q], 2);
          if ((lane & 3) == 0) {
            row_rgb[rA][q] = sigmoidf(c_lo[q] + bias[lay.b_rgb + q]);
            row_rgb[rA + 8][q] = sigmoidf(c_hi[q] + bias[lay.b_rgb + q]);
          }
        }
      }
      wg::wg_sync(bar);
    }

    // compositing: segments of `seg` lanes per ray, q samples a lane
    const int seg = SB < 32 ? SB : 32, q = SB / seg;
    if (SB > wg::kWgRows) {
      // a long ray: warp 0 takes the item's 128 samples, in order
      wg::consumers_sync();
      if (threadIdx.x < 32) {
        const long rr = ray0;
        const long base = rr * S + col0 + (long)k * wg::kItemRows;
        // the carry and the rgb sums along the ray (shared memory)
        float* run = s.long_run;
        if (k == 0 && lane == 0) {
          run[0] = first ? 0.0f : a.logT_in[rr];
          run[1] = run[2] = run[3] = 0.0f;
        }
        __syncwarp();
        const float lt_run = run[0];
        float c_run[3] = {0.0f, 0.0f, 0.0f};
        float x[wg::kLongQ], lg[wg::kLongQ], part = 0.0f;
#pragma unroll
        for (int j = 0; j < wg::kLongQ; ++j) {
          const int i = lane * wg::kLongQ + j;
          x[j] = __fmul_rn(density(s.row_sigma[i], a.softplus), a.d[base + i]);
          lg[j] = fmaxf(-x[j], kLogFloor);
          part += lg[j];
        }
        const float incl = wg::seg_scan(part, 32);
        float ex = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) ex = 0.0f;
        const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
        for (int j = 0; j < wg::kLongQ; ++j) {
          const int i = lane * wg::kLongQ + j;
          const float wk = __fmul_rn(1.0f - expf(-x[j]), expf(lt_run + ex));
          a.w_out[base + i] = wk;
          for (int c = 0; c < 3; ++c) c_run[c] += wk * s.row_rgb[i][c];
          ex += lg[j];
        }
        for (int c = 0; c < 3; ++c) c_run[c] = wg::seg_sum(c_run[c], 32);
        if (lane == 0) {
          run[0] = lt_run + total;
          for (int c = 0; c < 3; ++c) run[1 + c] += c_run[c];
          if (k == ipu - 1) {
            float* out = a.rgb + rr * 3;
            for (int c = 0; c < 3; ++c)
              out[c] = (first ? 0.0f : out[c]) + run[1 + c];
            a.logT_out[rr] = run[0];
          }
        }
        __syncwarp();
      }
      wg::consumers_sync();
    } else if (ww < 2 / q) {
      const int ray_l = ww * (32 / seg) + lane / seg;   // ray in the group
      const int ks = (lane & (seg - 1)) * q;            // its first sample
      const long rr = ray0 + ray_l;
      const float lt = first ? 0.0f : a.logT_in[rr];
      float x[2], lg[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[j] = lg[j] = 0.0f;
        if (j < q) {
          x[j] = __fmul_rn(density(row_sigma[ray_l * SB + ks + j], a.softplus),
                           a.d[rr * S + col0 + ks + j]);
          lg[j] = fmaxf(-x[j], kLogFloor);
        }
      }
      const float incl = wg::seg_scan(q == 2 ? lg[0] + lg[1] : lg[0], seg);
      float ex = __shfl_up_sync(0xffffffffu, incl, 1, seg);
      if ((lane & (seg - 1)) == 0) ex = 0.0f;
      const float total = __shfl_sync(0xffffffffu, incl, seg - 1, seg);
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < q) {
          const float wk = __fmul_rn(1.0f - expf(-x[j]), expf(lt + ex));
          a.w_out[rr * S + col0 + ks + j] = wk;
          const float* cr = row_rgb[ray_l * SB + ks + j];
          c0 += wk * cr[0];
          c1 += wk * cr[1];
          c2 += wk * cr[2];
          ex += lg[j];
        }
      }
      c0 = wg::seg_sum(c0, seg);
      c1 = wg::seg_sum(c1, seg);
      c2 = wg::seg_sum(c2, seg);
      if ((lane & (seg - 1)) == 0) {
        float* out = a.rgb + rr * 3;
        out[0] = (first ? 0.0f : out[0]) + c0;
        out[1] = (first ? 0.0f : out[1]) + c1;
        out[2] = (first ? 0.0f : out[2]) + c2;
        a.logT_out[rr] = lt + total;
      }
    }
    wg::wg_sync(bar);
  }
}

template <int W, bool kVd>
int launch_slim(SlimArgs& a, int device, cudaStream_t st) {
  const int smem = (int)sizeof(SlimSmem<W>) + a.n_b * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      set_smem((const void*)slim_march_kernel<W, kVd>, device, smem);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return (int)err;
  if (a.R == 0) return 0;
  slim_march_kernel<W, kVd><<<n_sm, kThreadsK2, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fnt

extern "C" {

// Marches sample block `blk` of NB: a net of width 128 or 256, with its
// view branch (has_vd 1) or without one (has_vd 0: the σ-only proposal
// nets; dirpart may be null); skip_mask: its skip layers (Layout). The
// predication tile is tile_rows (2048 or 1024) rows, tile_rows/SB rays; R
// must be a multiple of it and at most 1024 tiles; SB is a power of two
// with (tile_rows/SB) % 4 == 0 (wg::march_sb_ok); wp holds the net's march
// slices (kernels/wgpack.py). device: the operands' CUDA device. Returns a
// cudaError_t.
int fnt_slim_march(const void* hit, const void* block_hit, const void* oX,
                   const void* dX, const void* oF, const void* dF,
                   const void* dirpart, const void* t, const void* d,
                   const void* w, const void* wp, const void* b, void* rgb,
                   void* w_out, const void* logT_in, void* logT_out, int R,
                   int NB, int SB, int blk, int L, int depth, int width,
                   int k0, int skip_mask, int has_vd, int softplus,
                   int tile_rows,
                   float log_eps, int device, void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  SlimArgs a;
  a.hit = static_cast<const float*>(hit);
  a.block_hit = static_cast<const float*>(block_hit);
  a.oX = static_cast<const float*>(oX);
  a.dX = static_cast<const float*>(dX);
  a.oF = static_cast<const float*>(oF);
  a.dF = static_cast<const float*>(dF);
  a.dirpart = static_cast<const bf16*>(dirpart);
  a.t = static_cast<const float*>(t);
  a.d = static_cast<const float*>(d);
  a.w = static_cast<const bf16*>(w);
  a.wp = static_cast<const bf16*>(wp);
  a.b = static_cast<const float*>(b);
  a.rgb = static_cast<float*>(rgb);
  a.w_out = static_cast<float*>(w_out);
  a.logT_in = static_cast<const float*>(logT_in);
  a.logT_out = static_cast<float*>(logT_out);
  a.R = R;
  a.NB = NB;
  a.SB = SB;
  a.blk = blk;
  a.L = L;
  a.softplus = softplus;
  a.tile_rows = tile_rows;
  a.log_eps = log_eps;
  a.lay = make_layout(depth, width, k0, skip_mask, has_vd);
  a.n_b = has_vd ? a.lay.b_rgb + 3 : a.lay.b_out + 4;
  const bool shape_ok = (width == 128 || width == 256) &&
                        (!has_vd || dirpart != nullptr);
  if (layout_error(a.lay) || !shape_ok || 6 * L > k0 ||
      !(tile_rows == kTileRows || tile_rows == kTileRows / 2) ||
      !wg::march_sb_ok(SB, tile_rows) || R < 0 || R % (tile_rows / SB) ||
      R / (tile_rows / SB) > kMaxTilesK2 || blk < 0 || blk >= NB ||
      (reinterpret_cast<uintptr_t>(wp) & 15))
    return (int)cudaErrorInvalidValue;
  // the slices in the order the consumers take them (kernels/wgpack.py)
  int n = 0;
  auto add = [&](int rows, int cols) {
    for (int k = 0; k < rows; k += wg::kSliceK)
      if (n < kMaxSlices)
        a.slice_bytes[n++] = (rows - k < wg::kSliceK ? rows - k : wg::kSliceK)
                             * cols * 2;
  };
  for (int i = 0; i < depth; ++i) {
    if (a.lay.w_h[i] >= 0) add(width, width);
    if (a.lay.w_a0[i] >= 0) add(k0, width);
  }
  if (has_vd) {
    add(width, width);
    add(width, width / 2);
  }
  a.n_slices = n;
  if (n >= kMaxSlices) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_vd)
    return width == 256 ? launch_slim<256, true>(a, device, st)
                        : launch_slim<128, true>(a, device, st);
  return width == 256 ? launch_slim<256, false>(a, device, st)
                      : launch_slim<128, false>(a, device, st);
}

}  // extern "C"
