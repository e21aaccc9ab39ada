// Generic carry march of a full field (kernel K6), one sample block per
// launch.
//
// Replaces: src/fashion_nerf/kernels/blockmarch_pallas.py::_carry_kernel (via
// _carry_eval), the TPU kernel that marches a field over NB blocks of SB
// samples per ray with the transmittance carry and the rgb, depth and acc
// accumulators held in VMEM across a tile's sequential block programs,
// building each sample's position o + d·t inside the kernel.
//
// What bounds it on the H100: the same bf16 matrix products as the fine
// march K2 (the first and skip layers take [x | sin | cos] from the operand
// instead of a hoisted x-path: 3 more operand columns inside the same padded
// 64), so tensor-core throughput; next the L2 → shared-memory stream of the
// weights, once per 128 rows, the 6L accurate sines a row and the per-layer
// epilogues, which run serially with the wgmmas inside a warpgroup. The work
// it skips (dead (tile, block) pairs) is what a frame's time depends on most.
//
// Design: the fused field's forward (wgf::forward, csrc/wg_field.cuh, as
// field.cu runs it) inside the fine march's skeleton (csrc/slimmarch.cu):
// - Persistent CUDA blocks, one per SM, of two consumer warpgroups and one
//   producer warpgroup. A work item is 128 ray-major rows of sample block b,
//   64 per warpgroup = 64/SB whole rays. Every block lists the launch's live
//   predication tiles (2048/SB rays) itself and strides over their items;
//   the owner of a dead tile writes its w = 0 and carries rgb, depth, acc
//   and logT through. The tile is tile_rows rows: 2048, or 1024 for a
//   conditioned net, as the reference halves its conditioned plans' tile.
// - The producer's one lane streams the net's field slices
//   (kernels/wgpack.py::field_buffer, x rows inside the posenc operand's
//   slice) through the ring of 3 slots of 64 × 256 bf16 with cp.async.bulk
//   behind full/empty mbarriers; both warpgroups take every slice.
// - Each row's position is o + d·t in f32 without contraction
//   (__fmul_rn/__fadd_rn, as the plain version rounds), staged per item in
//   shared memory with t and the rays' view terms; wgf::posenc_tile builds
//   the operand [bf16(x) | bf16(sin P)] from it, and wgf::forward leaves
//   raw σ and post-sigmoid rgb per row in shared memory.
// - The cond window (a conditioned net, condpart non-null): the ray's
//   condpart row (n_cond·W bf16, the hoisted cond @ cond_kernel) is read
//   from device memory (L2) in the epilogues of the layers that take the
//   posenc operand, slice i added in f32 to the i-th one's accumulator
//   before its bias (wgf::forward<W, true>). A null condpart runs the
//   kernel instantiated without it.
// - Compositing by warps, as K2: one warp per ray (SB = 32, a lane per
//   sample), per 32/SB rays (SB < 32), or two samples a lane (SB = 64); the
//   exclusive log(1−α) prefix, clamped at log(1e-10) per sample, is a
//   shuffle scan on the carried logT, and rgb, depth (Σ w·t) and acc (Σ w)
//   are segment sums added to the accumulators in device memory.
// - Every SB the reference takes, as K2 (wg::march_sb_ok): below 16 the
//   view terms and cond rows of a warpgroup's rays are read from device
//   memory; above 64 warp 0 composites each item's 128 samples of the ray
//   in order, one CUDA block running a ray's items (wg::unit_row0).
// Predication is part of the result: a (tile, b) pair runs iff some ray of
// the tile has hit ∧ block_hit[b] ∧ logT > log ε, and then every ray of the
// tile is marched. The decision reads logT_in, written by the previous
// launch; the launch writes logT_out, so no block reads a carry that another
// block of the same launch updates.
#include "wg_field.cuh"

namespace fnt {
namespace {

constexpr int kStagesK6 = 3;
constexpr int kMaxTilesK6 = 1024;
constexpr int kMaxRaysK6 = wg::kWgRows / 16;   // rays staged a warpgroup

template <int W>
struct __align__(128) CarrySmem {
  bf16 h[2][wg::kWgRows * W];        // activations per warpgroup
  bf16 a0[2][wg::kWgRows * kMaxK0];  // posenc operand per warpgroup
  wgf::Ring<kStagesK6> ring;         // weight slices
  bf16 dirs[2][kMaxRaysK6][W / 2];   // view terms of a warpgroup's rays
  float pts[2][wg::kWgRows][3];
  float heads[W * 4];                // σ and rgb heads, or the out head
  float row_t[wg::kItemRows];
  float row_sigma[wg::kItemRows];
  float row_rgb[wg::kItemRows][3];
  float long_run[6];   // a long ray's log-T carry, rgb, depth and acc sums
  int n_live;
  uint8_t tile_live[kMaxTilesK6];
  uint16_t live[kMaxTilesK6];
  // the net's biases follow (CarryArgs::n_b floats)
};

struct CarryArgs {
  const float* hit;        // (R,) AABB hit flags
  const float* block_hit;  // (R, NB) macro-box flags per sample block
  const float* rays_o;     // (R, 3)
  const float* rays_d;     // (R, 3)
  const bf16* dirpart;     // (R, W/2) per-ray view term (view branch only)
  const bf16* condpart;    // (R, cw) per-ray cond term, or null
  const float* t;          // (R, NB·SB) sample positions
  const float* d;          // (R, NB·SB) scaled interval widths
  const bf16* w;           // packed weights (Layout): the heads
  const bf16* wp;          // field slices (kernels/wgpack.py)
  const float* b;          // packed biases
  float* rgb;              // (R, 3) accumulated radiance
  float* depth;            // (R,) accumulated Σ w·t
  float* acc;              // (R,) accumulated Σ w
  float* w_out;            // (R, NB·SB) weights
  const float* logT_in;    // (R,) carry before block b (unused at b = 0)
  float* logT_out;         // (R,) carry after block b
  int R, NB, SB, blk, L, softplus, n_b;
  int cw;                  // condpart columns (n_cond·W), 0 without one
  int tile_rows;           // rows of a predication tile (2048 or 1024)
  float log_eps;
  int n_slices;
  int slice_bytes[wgf::kMaxSlices];
  Layout lay;
};

// kOneRay: SB ≥ 16, rows rA and rA + 8 in one ray (its view term and
// cond row read once); the other instantiations take SB < 16.
template <int W, bool kCond, bool kOneRay>
__global__ void __launch_bounds__(wgf::kThreads, 1)
    carry_march_kernel(const __grid_constant__ CarryArgs a) {
  constexpr int kHalf = W / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  CarrySmem<W>& s = *reinterpret_cast<CarrySmem<W>*>(smem_raw);
  float* bias = reinterpret_cast<float*>(smem_raw + sizeof(CarrySmem<W>));
  const Layout& lay = a.lay;
  const int SB = a.SB, S = a.NB * a.SB;
  const int rpt = a.tile_rows / SB;
  const bool first = a.blk == 0;
  const long col0 = (long)a.blk * SB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) wgf::ring_init(s.ring);
  for (int i = threadIdx.x; i < a.n_b; i += blockDim.x) bias[i] = a.b[i];
  if (lay.has_vd) {
    for (int i = threadIdx.x; i < W; i += blockDim.x)
      s.heads[i] = bf(a.w[lay.w_sig + i]);
    for (int i = threadIdx.x; i < kHalf * 3; i += blockDim.x)
      s.heads[W + i] = bf(a.w[lay.w_rgb + i]);
  } else {
    for (int i = threadIdx.x; i < W * 4; i += blockDim.x)
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
          if (first) {
            for (int c = 0; c < 3; ++c) a.rgb[ray * 3 + c] = 0.0f;
            a.depth[ray] = 0.0f;
            a.acc[ray] = 0.0f;
          }
        }
      });
  const int n_units = n_live * (a.tile_rows / wg::unit_rows(SB));
  const int ipu = wg::unit_items(SB);

  if (warp >= wgf::kConsumers / 32) {
    wg::setmaxnreg_dec<40>();
    if (warp == wgf::kConsumers / 32 && lane == 0)
      wgf::produce(s.ring, a.wp, a.slice_bytes, a.n_slices, n_units, nullptr,
                   0, ipu);
    return;
  }

  // consumers: warpgroup g owns rows [64g, 64g + 64) of each item
  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, tw = threadIdx.x & 127, ww = tw >> 5;
  float(*pts)[3] = s.pts[g];
  bf16(*dirs)[kHalf] = s.dirs[g];
  float* row_t = s.row_t + 64 * g;
  float* row_sigma = s.row_sigma + 64 * g;
  float(*row_rgb)[3] = s.row_rgb + 64 * g;
  // rays of the warpgroup's rows; their view terms staged, or read from L2
  const int nr = SB < wg::kWgRows ? wg::kWgRows / SB : 1;
  const bool staged = nr <= kMaxRaysK6;
  wgf::Rows t{s.h[g], s.a0[g], bias, s.heads, pts, nullptr, nullptr,
              row_sigma, row_rgb, nullptr, tw, ww, lane, 1 + g,
              16 * ww + (lane >> 2), 2 * (lane & 3)};
  // the rays of rows rA and rA + 8 (one ray at SB ≥ 16)
  const int rl_lo = t.rA / SB, rl_hi = (t.rA + 8) / SB;
  t.dir_lo = dirs[staged ? rl_lo : 0];
  t.dir_hi = dirs[staged ? rl_hi : 0];
  wgf::RingPos rp{0, 0u, -1};
  float acc[W / 2];

  for (int u = blockIdx.x; u < n_units; u += gridDim.x)
  for (int k = 0; k < ipu; ++k) {
    const long row0 = wg::unit_row0(s.live, u, k, g, a.tile_rows, SB);
    const long ray0 = row0 / SB;   // first ray of the warpgroup
    if (kCond) {
      t.cond_lo = a.condpart + (ray0 + rl_lo) * a.cw;
      t.cond_hi = a.condpart + (ray0 + rl_hi) * a.cw;
    }
    if (tw < 64)
      row_t[tw] = SB <= wg::kWgRows
                      ? a.t[(ray0 + tw / SB) * S + col0 + tw % SB]
                      : a.t[ray0 * S + col0 + row0 % SB + tw];
    if (lay.has_vd && staged)
      for (int i = tw; i < nr * kHalf; i += 128)
        dirs[i / kHalf][i % kHalf] = a.dirpart[ray0 * kHalf + i];
    if (lay.has_vd && !staged) {
      t.dir_lo = a.dirpart + (ray0 + rl_lo) * kHalf;
      t.dir_hi = a.dirpart + (ray0 + rl_hi) * kHalf;
    }
    wg::wg_sync(t.bar);
    for (int i = tw; i < 64 * 3; i += 128) {
      const int r = i / 3, c = i % 3;
      const long ray = ray0 + r / SB;
      pts[r][c] = __fadd_rn(a.rays_o[ray * 3 + c],
                            __fmul_rn(a.rays_d[ray * 3 + c], row_t[r]));
    }
    wg::wg_sync(t.bar);
    wgf::posenc_tile(t.A0, lay.k0, a.L, pts, tw);
    wg::fence_async_smem();
    wg::wg_sync(t.bar);

    wgf::forward<W, kCond, kOneRay>(lay, t, s.ring, rp, acc,
                                    [](int, int) {}, [] {});

    // compositing: segments of `seg` lanes per ray, q samples a lane
    const int seg = SB < 32 ? SB : 32, q = SB / seg;
    if (SB > wg::kWgRows) {
      // a long ray: warp 0 takes the item's 128 samples, in order
      wg::consumers_sync();
      if (threadIdx.x < 32) {
        const long rr = ray0;
        const long base = rr * S + col0 + (long)k * wg::kItemRows;
        // the carry and the rgb, depth and acc sums along the ray
        float* run = s.long_run;
        if (k == 0 && lane == 0) {
          run[0] = first ? 0.0f : a.logT_in[rr];
          for (int c = 1; c < 6; ++c) run[c] = 0.0f;
        }
        __syncwarp();
        const float lt_run = run[0];
        float c_run[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
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
          c_run[3] += wk * s.row_t[i];
          c_run[4] += wk;
          ex += lg[j];
        }
        for (int c = 0; c < 5; ++c) c_run[c] = wg::seg_sum(c_run[c], 32);
        if (lane == 0) {
          run[0] = lt_run + total;
          for (int c = 0; c < 5; ++c) run[1 + c] += c_run[c];
          if (k == ipu - 1) {
            float* out = a.rgb + rr * 3;
            for (int c = 0; c < 3; ++c)
              out[c] = (first ? 0.0f : out[c]) + run[1 + c];
            a.depth[rr] = (first ? 0.0f : a.depth[rr]) + run[4];
            a.acc[rr] = (first ? 0.0f : a.acc[rr]) + run[5];
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
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f, ac = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < q) {
          const int r = ray_l * SB + ks + j;
          const float wk = __fmul_rn(1.0f - expf(-x[j]), expf(lt + ex));
          a.w_out[rr * S + col0 + ks + j] = wk;
          c0 += wk * row_rgb[r][0];
          c1 += wk * row_rgb[r][1];
          c2 += wk * row_rgb[r][2];
          dep += wk * row_t[r];
          ac += wk;
          ex += lg[j];
        }
      }
      c0 = wg::seg_sum(c0, seg);
      c1 = wg::seg_sum(c1, seg);
      c2 = wg::seg_sum(c2, seg);
      dep = wg::seg_sum(dep, seg);
      ac = wg::seg_sum(ac, seg);
      if ((lane & (seg - 1)) == 0) {
        float* out = a.rgb + rr * 3;
        out[0] = (first ? 0.0f : out[0]) + c0;
        out[1] = (first ? 0.0f : out[1]) + c1;
        out[2] = (first ? 0.0f : out[2]) + c2;
        a.depth[rr] = (first ? 0.0f : a.depth[rr]) + dep;
        a.acc[rr] = (first ? 0.0f : a.acc[rr]) + ac;
        a.logT_out[rr] = lt + total;
      }
    }
    wg::wg_sync(t.bar);
  }
}

template <int W, bool kCond, bool kOneRay>
int launch_carry(CarryArgs& a, int device, cudaStream_t st) {
  const int smem = (int)sizeof(CarrySmem<W>) + a.n_b * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(
      (const void*)carry_march_kernel<W, kCond, kOneRay>, device, smem);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return (int)err;
  if (a.R == 0) return 0;
  carry_march_kernel<W, kCond, kOneRay><<<n_sm, wgf::kThreads, smem, st>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fnt

extern "C" {

// Marches sample block `blk` of NB with a field packed with its x rows in
// the posenc operand: width 128 or 256, depth 2-8, k0 48 or 64. condpart:
// null, or (R, cw) bf16 with cw = W times the layers that take the posenc
// operand. The predication tile is tile_rows (2048 or 1024) rows; R must
// be a multiple of it (tile_rows/SB rays) and at most 1024 tiles; SB is a
// power of two with (tile_rows/SB) % 4 == 0 (wg::march_sb_ok); wp holds
// the net's field slices
// (kernels/wgpack.py::field_buffer). device: the operands' CUDA device.
// Returns a cudaError_t.
int fnt_carry_march(const void* hit, const void* block_hit,
                    const void* rays_o, const void* rays_d,
                    const void* dirpart, const void* t, const void* d,
                    const void* w, const void* wp, const void* b, void* rgb,
                    void* depth, void* acc, void* w_out, const void* logT_in,
                    void* logT_out, const void* condpart, int cw, int R,
                    int NB, int SB, int blk, int L, int depth_layers,
                    int width, int k0, int skip_mask, int has_vd, int softplus,
                    int tile_rows, float log_eps, int device,
                    void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  CarryArgs a;
  a.hit = static_cast<const float*>(hit);
  a.block_hit = static_cast<const float*>(block_hit);
  a.rays_o = static_cast<const float*>(rays_o);
  a.rays_d = static_cast<const float*>(rays_d);
  a.dirpart = static_cast<const bf16*>(dirpart);
  a.condpart = static_cast<const bf16*>(condpart);
  a.cw = cw;
  a.tile_rows = tile_rows;
  a.t = static_cast<const float*>(t);
  a.d = static_cast<const float*>(d);
  a.w = static_cast<const bf16*>(w);
  a.wp = static_cast<const bf16*>(wp);
  a.b = static_cast<const float*>(b);
  a.rgb = static_cast<float*>(rgb);
  a.depth = static_cast<float*>(depth);
  a.acc = static_cast<float*>(acc);
  a.w_out = static_cast<float*>(w_out);
  a.logT_in = static_cast<const float*>(logT_in);
  a.logT_out = static_cast<float*>(logT_out);
  a.R = R;
  a.NB = NB;
  a.SB = SB;
  a.blk = blk;
  a.L = L;
  a.softplus = softplus;
  a.log_eps = log_eps;
  a.lay = make_layout(depth_layers, width, k0, skip_mask, has_vd);
  a.n_b = has_vd ? a.lay.b_rgb + 3 : a.lay.b_out + 4;
  a.n_slices = wgf::field_slice_bytes(a.lay, false, a.slice_bytes);
  if (wgf::field_layout_error(a.lay) || a.n_slices < 0 || 3 + 6 * L > k0 ||
      R < 0 || !(tile_rows == kTileRows || tile_rows == kTileRows / 2) ||
      !wg::march_sb_ok(SB, tile_rows) ||
      R % (tile_rows / SB) || R / (tile_rows / SB) > kMaxTilesK6 || blk < 0 ||
      blk >= NB || (reinterpret_cast<uintptr_t>(wp) & 15) ||
      (condpart != nullptr) != (cw > 0) ||
      (cw > 0 && (cw != wgf::cond_layers(a.lay) * width ||
                  (reinterpret_cast<uintptr_t>(condpart) & 3))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dv = device;
  if (cw > 0) {
    if (SB >= 16)
      return width == 256 ? launch_carry<256, true, true>(a, dv, st)
                          : launch_carry<128, true, true>(a, dv, st);
    return width == 256 ? launch_carry<256, true, false>(a, dv, st)
                        : launch_carry<128, true, false>(a, dv, st);
  }
  if (SB >= 16)
    return width == 256 ? launch_carry<256, false, true>(a, dv, st)
                        : launch_carry<128, false, true>(a, dv, st);
  return width == 256 ? launch_carry<256, false, false>(a, dv, st)
                      : launch_carry<128, false, false>(a, dv, st);
}

}  // extern "C"
