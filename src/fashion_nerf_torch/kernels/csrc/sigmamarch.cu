// σ-only single-block proposal march (kernel K1).
//
// Replaces: src/fashion_nerf/kernels/sigmamarch_pallas.py::_sigma_kernel
// (via _sigma_march_eval), the TPU kernel that marches the 2x128 σ-only
// proposal net over one block of SB samples per ray.
//
// What bounds it on the H100: a small net (48×128 + 128×128 + 128×4 =
// 23,040 MACs a row) against ~12 bytes of per-row input (t, d, w), so in
// principle the tensor cores; in practice the per-row work beside them:
// 36 accurate sines a row for the posenc operand and the epilogues.
//
// Design (csrc/wg_trunk.cuh holds the shared pieces):
// - The whole net stays resident: each persistent CUDA block (two per SM)
//   loads its march slices (kernels/wgpack.py, 45 KB at 2×128) once by one
//   cp.async.bulk behind an mbarrier and keeps them for every work item.
// - A work item is 128 rows (ray-major), 64 per consumer warpgroup; the
//   predication tile of 2048/SB rays holds 16 items. Every block lists the
//   launch's live tiles (a tile with any alive ray is marched whole) and
//   strides over their items; the owner block of a dead tile writes
//   w = 0, acc = 0, logT = 0.
// - Layers on wgmma m64n128k16, the 64×128 f32 accumulator 64 registers a
//   thread; the first layer's epilogue adds the hoisted x-term
//   oWx + dWx·t (per-ray hoists staged in shared memory once per item)
//   and writes the bf16 activations in place; the last layer's epilogue
//   takes the out head's σ column (128→1) as a register dot product
//   reduced over the 4 lanes of a row.
// - The per-ray prefix by one warp per ray: at SB = 64 each lane holds two
//   samples and the exclusive log(1−α) prefix is a shuffle scan; below 32
//   a warp's lanes split into segments of SB lanes, one ray each.
// - Every SB the reference takes (wg::march_sb_ok: powers of two to 512).
//   Below 16 a warpgroup's 64 rows hold more rays than the per-ray hoists
//   staged in shared memory, so the epilogues read them from device memory
//   (L2). Above 64 a ray spans both warpgroups, and above 128 several
//   items: one CUDA block runs a ray's items in order (wg::unit_row0), and
//   after each item warp 0 composites its 128 samples, the exclusive
//   prefix carried in registers from item to item.
#include "fnt_common.cuh"
#include "wg_trunk.cuh"

namespace fnt {
namespace {

constexpr int kW1 = 128;            // trunk width of this kernel
constexpr int kThreadsK1 = 2 * 128;  // two warpgroups
constexpr int kMaxTilesK1 = 1024;
constexpr int kMaxRaysWg = wg::kWgRows / 16;   // rays staged a warpgroup

struct __align__(128) SigmaSmem {
  bf16 h[2][wg::kWgRows * kW1];        // activations per warpgroup
  bf16 a0[2][wg::kWgRows * kMaxK0];    // posenc operand per warpgroup
  // per-ray inputs of a warpgroup's rays, staged once per item
  float hx[2][kMaxRaysWg][2][kW1];     // oWx, dWx
  float ph[2][kMaxRaysWg][2][kMaxK0];  // oF, dF
  float wsig[kW1];                     // the out head's σ column
  float row_t[wg::kItemRows];
  float row_sigma[wg::kItemRows];
  float long_run[2];   // a long ray's log-T carry and Σ w
  uint64_t wbar;
  int n_live;
  uint8_t tile_live[kMaxTilesK1];
  uint16_t live[kMaxTilesK1];
  // the resident march slices follow (SigmaArgs::wp_bytes), then the
  // net's biases (SigmaArgs::n_b floats)
};

struct SigmaArgs {
  const float* alive;   // (R,) hit ∧ block-hit flags
  const float* oWx;     // (R, W) first-layer x intercept (bias folded)
  const float* dWx;     // (R, W) first-layer x slope
  const float* oF;      // (R, 6L) phase intercept (π/2 offset folded)
  const float* dF;      // (R, 6L) phase slope
  const float* t;       // (R, SB) sample positions
  const float* d;       // (R, SB) scaled interval widths
  const bf16* w;        // packed weights (Layout): the out head
  const bf16* wp;       // march slices (kernels/wgpack.py)
  const float* b;       // packed biases (first-layer bias is 0: hoisted)
  float* w_out;         // (R, SB)
  float* acc;           // (R,)
  float* logT;          // (R,)
  int R, SB, L, softplus, wp_bytes, n_b;
  Layout lay;
};

// kFew: SB < 16, more rays a warpgroup than are staged (the hoists are
// read from L2); kLong: SB > 64, a ray spans both warpgroups (and items).
// The instantiation without either takes SB 16-64.
template <bool kFew, bool kLong>
__global__ void __launch_bounds__(kThreadsK1, 2)
    sigma_march_kernel(const __grid_constant__ SigmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SigmaSmem& s = *reinterpret_cast<SigmaSmem*>(smem_raw);
  bf16* wres = reinterpret_cast<bf16*>(smem_raw + sizeof(SigmaSmem));
  float* bias = reinterpret_cast<float*>(smem_raw + sizeof(SigmaSmem) +
                                         a.wp_bytes);
  const Layout& lay = a.lay;
  const int SB = a.SB, rpt = kTileRows / SB;

  if (threadIdx.x == 0) {
    wg::mbar_init(&s.wbar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(&s.wbar, a.wp_bytes);
    wg::bulk_load(wres, a.wp, a.wp_bytes, &s.wbar);
  }
  // shared memory leaves little L1: everything the epilogues read is
  // staged here, the biases and the σ column once per block
  for (int i = threadIdx.x; i < a.n_b; i += blockDim.x) bias[i] = a.b[i];
  for (int i = threadIdx.x; i < kW1; i += blockDim.x)
    s.wsig[i] = bf(a.w[lay.w_out + i * 4 + 3]);
  const int n_live = wg::live_tiles(
      a.R / rpt, rpt, s.tile_live, s.live, &s.n_live,
      [&](long ray) { return a.alive[ray] > 0.0f; },
      [&](int tile, int ln) {
        const long ray0 = (long)tile * rpt;
        for (int i = ln; i < rpt * SB; i += 32) a.w_out[ray0 * SB + i] = 0.0f;
        for (int i = ln; i < rpt; i += 32) {
          a.acc[ray0 + i] = 0.0f;
          a.logT[ray0 + i] = 0.0f;
        }
      });
  wg::mbar_wait(&s.wbar, 0);
  const int n_units = n_live * (kTileRows / wg::unit_rows(SB));
  const int ipu = wg::unit_items(SB);

  const int g = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int ww = tw >> 5, lane = threadIdx.x & 31;
  const int bar = 1 + g;
  bf16* H = s.h[g];
  bf16* A0 = s.a0[g];
  const uint32_t h_addr = wg::smem_addr(H), a0_addr = wg::smem_addr(A0);
  const uint32_t w_addr = wg::smem_addr(wres);
  float* row_t = s.row_t + 64 * g;
  float* row_sigma = s.row_sigma + 64 * g;
  float(*hx)[2][kW1] = s.hx[g];
  float(*ph)[2][kMaxK0] = s.ph[g];
  const int k0 = lay.k0, n_ph = 6 * a.L;
  // rays of the warpgroup's rows; their hoists staged, or read from L2
  const int nr = SB < wg::kWgRows ? wg::kWgRows / SB : 1;
  constexpr bool staged = !kFew;
  const int rA = 16 * ww + (lane >> 2), cA = 2 * (lane & 3);
  float acc[kW1 / 2];

  for (int u = blockIdx.x; u < n_units; u += gridDim.x)
  for (int k = 0; k < ipu; ++k) {
    const long row0 = wg::unit_row0(s.live, u, k, g, kTileRows, SB);
    const long ray0 = row0 / SB;   // first ray of this warpgroup
    if (tw < 64) row_t[tw] = a.t[row0 + tw];
    if (staged) {
      for (int i = tw; i < nr * 2 * kW1; i += 128) {
        const int r = i / (2 * kW1), which = (i / kW1) & 1, c = i % kW1;
        hx[r][which][c] = (which ? a.dWx : a.oWx)[(ray0 + r) * kW1 + c];
      }
      for (int i = tw; i < nr * 2 * n_ph; i += 128) {
        const int r = i / (2 * n_ph), which = (i / n_ph) & 1, c = i % n_ph;
        ph[r][which][c] = (which ? a.dF : a.oF)[(ray0 + r) * n_ph + c];
      }
    }
    wg::wg_sync(bar);
    // the phases staged in shared memory, or (few rays) read from L2
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
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(A0) +
                                           wg::cm_off(r, c, k0)) =
            __floats2bfloat162_rn(v0, v1);
      }
    };
    if constexpr (staged)
      posenc(std::true_type{});
    else
      posenc(std::false_type{});
    wg::fence_async_smem();
    wg::wg_sync(bar);

    // the rays of rows rA and rA + 8 (one ray at SB ≥ 16): their x-term
    // hoists staged, or (few rays) in oWx / dWx
    const int rl_lo = rA / SB, rl_hi = (rA + 8) / SB;
    const int rl = staged ? rl_lo : 0;
    const float* gox_lo = a.oWx + (ray0 + rl_lo) * kW1;
    const float* gdx_lo = a.dWx + (ray0 + rl_lo) * kW1;
    const float* gox_hi = a.oWx + (ray0 + rl_hi) * kW1;
    const float* gdx_hi = a.dWx + (ray0 + rl_hi) * kW1;
    const float t_lo = row_t[rA], t_hi = row_t[rA + 8];
    uint32_t woff = 0;        // byte offset of the layer's first slice
    for (int i = 0; i < lay.depth; ++i) {
      wg::mma_fence();
      if (lay.w_h[i] >= 0) {
        for (int k = 0; k < kW1; k += wg::kSliceK) {
          wg::mma_slice<kW1>(acc, h_addr, kW1, k, w_addr + woff,
                             wg::kSliceK, k == 0);
          woff += wg::kSliceK * kW1 * 2;
        }
      } else {
        wg::mma_slice<kW1>(acc, a0_addr, k0, 0, w_addr + woff, k0, true);
        woff += k0 * kW1 * 2;
      }
      wg::mma_commit();
      wg::mma_wait<0>();
      wg::fence_regs(acc);
      wg::wg_sync(bar);   // the whole warpgroup is done reading H
      const float* bl = bias + lay.b[i];
      const bool xlayer = i == 0, last = i == lay.depth - 1;
      float sg_lo = 0.0f, sg_hi = 0.0f;
      auto epilogue = [&](auto from_smem) {
#pragma unroll
      for (int j = 0; j < kW1 / 8; ++j) {
        const int c = 8 * j + cA;
        const float b0 = bl[c], b1 = bl[c + 1];
        float v[4] = {__fadd_rn(acc[4 * j], b0), __fadd_rn(acc[4 * j + 1], b1),
                      __fadd_rn(acc[4 * j + 2], b0),
                      __fadd_rn(acc[4 * j + 3], b1)};
        if (xlayer) {
          if constexpr (decltype(from_smem)::value) {
            const float o0 = hx[rl][0][c], o1 = hx[rl][0][c + 1];
            const float d0 = hx[rl][1][c], d1 = hx[rl][1][c + 1];
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
        if (last) {
          const float s0 = s.wsig[c], s1 = s.wsig[c + 1];
          sg_lo = fmaf(__low2float(lo), s0, fmaf(__high2float(lo), s1, sg_lo));
          sg_hi = fmaf(__low2float(hi), s0, fmaf(__high2float(hi), s1, sg_hi));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(H) +
                                             wg::cm_off(rA, c, kW1)) = lo;
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(H) +
                                             wg::cm_off(rA + 8, c, kW1)) = hi;
        }
      }
      };
      if constexpr (staged)
        epilogue(std::true_type{});
      else
        epilogue(std::false_type{});
      if (last) {
        sg_lo += __shfl_xor_sync(0xffffffffu, sg_lo, 1);
        sg_lo += __shfl_xor_sync(0xffffffffu, sg_lo, 2);
        sg_hi += __shfl_xor_sync(0xffffffffu, sg_hi, 1);
        sg_hi += __shfl_xor_sync(0xffffffffu, sg_hi, 2);
        if ((lane & 3) == 0) {
          row_sigma[rA] = sg_lo + bias[lay.b_out + 3];
          row_sigma[rA + 8] = sg_hi + bias[lay.b_out + 3];
        }
      } else {
        wg::fence_async_smem();
      }
      wg::wg_sync(bar);
    }

    // compositing: segments of `seg` lanes per ray, q samples a lane
    const int seg = SB < 32 ? SB : 32, q = SB / seg;
    if constexpr (kLong) {
      // a long ray: warp 0 takes the item's 128 samples, in order
      wg::consumers_sync();
      if (threadIdx.x < 32) {
        const long base = ray0 * SB + (long)k * wg::kItemRows;
        // the carry and Σ w along the ray (shared memory)
        float* run = s.long_run;
        if (k == 0 && lane == 0) run[0] = run[1] = 0.0f;
        __syncwarp();
        const float lt_run = run[0];
        float acc_run = 0.0f;
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
          const float wk = __fmul_rn(1.0f - expf(-x[j]), expf(lt_run + ex));
          a.w_out[base + lane * wg::kLongQ + j] = wk;
          acc_run += wk;
          ex += lg[j];
        }
        acc_run = wg::seg_sum(acc_run, 32);
        if (lane == 0) {
          run[0] = lt_run + total;
          run[1] += acc_run;
          if (k == ipu - 1) {
            a.acc[ray0] = run[1];
            a.logT[ray0] = run[0];
          }
        }
        __syncwarp();
      }
      wg::consumers_sync();
    } else if (ww < 2 / q) {
      const int ray_l = ww * (32 / seg) + lane / seg;
      const int ks = (lane & (seg - 1)) * q;
      const long rr = ray0 + ray_l;
      float x[2], lg[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[j] = lg[j] = 0.0f;
        if (j < q) {
          x[j] = __fmul_rn(density(row_sigma[ray_l * SB + ks + j], a.softplus),
                           a.d[rr * SB + ks + j]);
          lg[j] = fmaxf(-x[j], kLogFloor);
        }
      }
      const float incl = wg::seg_scan(q == 2 ? lg[0] + lg[1] : lg[0], seg);
      float ex = __shfl_up_sync(0xffffffffu, incl, 1, seg);
      if ((lane & (seg - 1)) == 0) ex = 0.0f;
      const float total = __shfl_sync(0xffffffffu, incl, seg - 1, seg);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < q) {
          const float wk = __fmul_rn(1.0f - expf(-x[j]), expf(ex));
          a.w_out[rr * SB + ks + j] = wk;
          sum += wk;
          ex += lg[j];
        }
      }
      sum = wg::seg_sum(sum, seg);
      if ((lane & (seg - 1)) == 0) {
        a.acc[rr] = sum;
        a.logT[rr] = total;
      }
    }
    wg::wg_sync(bar);
  }
}

}  // namespace
}  // namespace fnt

extern "C" {

// The proposal march of a 128-wide σ-only net. R must be a multiple of the
// tile (2048/SB rays) and at most 1024 tiles; SB is a power of two with
// (2048/SB) % 4 == 0 (wg::march_sb_ok); wp holds
// the net's march slices (kernels/wgpack.py, wp_elems bf16). device: the
// operands' CUDA device. Returns a cudaError_t.
int fnt_sigma_march(const void* alive, const void* oWx, const void* dWx,
                    const void* oF, const void* dF, const void* t,
                    const void* d, const void* w, const void* wp,
                    const void* b, void* w_out, void* acc, void* logT, int R,
                    int SB, int L, int depth, int width, int k0, int softplus,
                    int wp_elems, int device, void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  SigmaArgs a;
  a.alive = static_cast<const float*>(alive);
  a.oWx = static_cast<const float*>(oWx);
  a.dWx = static_cast<const float*>(dWx);
  a.oF = static_cast<const float*>(oF);
  a.dF = static_cast<const float*>(dF);
  a.t = static_cast<const float*>(t);
  a.d = static_cast<const float*>(d);
  a.w = static_cast<const bf16*>(w);
  a.wp = static_cast<const bf16*>(wp);
  a.b = static_cast<const float*>(b);
  a.w_out = static_cast<float*>(w_out);
  a.acc = static_cast<float*>(acc);
  a.logT = static_cast<float*>(logT);
  a.R = R;
  a.SB = SB;
  a.L = L;
  a.softplus = softplus;
  a.lay = make_layout(depth, width, k0, 0, 0);
  a.wp_bytes = wp_elems * 2;
  a.n_b = a.lay.b_out + 4;
  const int expect = k0 * kW1 + (depth - 1) * kW1 * kW1;
  const int smem = (int)sizeof(SigmaSmem) + a.wp_bytes + a.n_b * 4;
  if (layout_error(a.lay) || width != kW1 || !wg::march_sb_ok(SB, kTileRows) ||
      6 * L > k0 || R < 0 || R % (kTileRows / SB) ||
      R / (kTileRows / SB) > kMaxTilesK1 || wp_elems != expect ||
      smem > 227 * 1024 || (reinterpret_cast<uintptr_t>(wp) & 15))
    return (int)cudaErrorInvalidValue;
  auto kernel = SB < 16 ? sigma_march_kernel<true, false>
                : SB > wg::kWgRows ? sigma_march_kernel<false, true>
                                   : sigma_march_kernel<false, false>;
  cudaError_t err = set_smem((const void*)kernel, device, smem);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0, per_sm = 0;
  err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return (int)err;
  err = blocks_per_sm((const void*)kernel, device, kThreadsK1, smem,
                      &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (R == 0) return 0;
  kernel<<<n_sm * per_sm, kThreadsK1, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
