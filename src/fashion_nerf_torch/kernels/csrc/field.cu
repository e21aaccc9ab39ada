// Fused posenc + NeRF-MLP field, forward (kernel K3).
//
// Replaces: src/fashion_nerf/kernels/posenc_mlp_pallas.py::_field_kernel
// (via _fused_eval / make_fused_field), the TPU kernel that evaluates the
// whole field on 2048-row tiles with activations resident in VMEM.
//
// What bounds it on the H100: bf16 matrix products. A row costs ~0.59M MACs
// of the 8x256 field against 12 bytes of row input/output and a per-ray
// 256-byte view term, so it is far above the bf16 ridge (~295 FLOP/byte);
// the limit is tensor-core throughput, then the L2 → shared-memory stream
// of the 1.18 MB of weights (once per 128 rows) and the per-layer
// epilogues, which run serially with the wgmmas inside a warpgroup.
//
// Design (csrc/wg_field.cuh, csrc/wg_trunk.cuh hold the shared pieces), on
// the skeleton of the fine march (slimmarch.cu):
// - Persistent CUDA blocks, one per SM, of two consumer warpgroups and one
//   producer warpgroup (setmaxnreg hands the producer's registers to the
//   consumers). A work item is 128 rows, 64 per warpgroup; a row count
//   that is 64 mod 128 leaves the last item's second warpgroup without
//   rows: it runs on, reading and writing nothing in device memory.
// - Layers on wgmma m64n256k16 (m64n128k16 for the view layer, half that
//   at width 128) from shared-memory A and B; the weights stream through a
//   ring of 3 slices of 64 × 256 bf16 by cp.async.bulk behind full/empty
//   mbarriers (kernels/wgpack.py packs the slices with one gather a call).
// - The posenc operand is built per row from pts: [x | sin(x·2^f (+π/2))],
//   the phases by __fmul_rn/__fadd_rn as the plain version rounds; the x
//   rows stay in the operand (k0 = 64 at L = 10, 48 at L = 6).
// - Each layer's epilogue runs in registers and writes bf16 in place over
//   the warpgroup's activation tile: bias, relu, bf16. The σ head rides
//   the last trunk epilogue and the rgb head the view epilogue, as
//   register dot products reduced over the 4 lanes of a row (the 4-wide
//   head likewise without a view branch). Biases, heads and the per-ray
//   view term are staged in shared memory (up to 8 rays a warpgroup; more,
//   at spr < 10, are read from device memory in the view epilogue).
// - The cond window (the reference's condpart window of conditioned
//   plans): with a non-null condpart (n / spr, cw) bf16, the hoisted
//   per-ray cond @ cond_kernel, each row's accumulator in the epilogue of
//   the i-th layer that takes the posenc operand (trunk_0, each skip layer)
//   adds the f32 of its ray's slice i before the bias, read from device
//   memory (L2-resident: one row serves spr rows). A null condpart runs
//   the kernel instantiated without it.
// - The tile-skip flag (the reference's per-tile `alive`, fed by the
//   two-stage march of render/blockwise.py): with a non-null alive, one
//   f32 flag per predication tile of tile_rows rows (2048, 1024 for a
//   conditioned net; the whole launch when it is shorter), a tile whose
//   flag is not > 0 does no matrix work and writes rgb = 0 and
//   σ = kDeadSigma. A work item lies inside one tile, and every warpgroup
//   reads the flag of its item's tile before the item: the producer issues
//   no slices for a dead item and both consumers skip it, so the ring's
//   phases stay in step. The reference keeps the flags in SMEM packed 128
//   wide, a TPU layout; here they are a plain device array, one load per
//   item and warpgroup.
#include "wg_field.cuh"

namespace fnt {
namespace {

constexpr int kStagesK3 = 3;
constexpr float kDeadSigma = -1e10f;   // post-relu density 0: zero weight

template <int W>
struct __align__(128) FieldSmem {
  bf16 h[2][wg::kWgRows * W];        // activations per warpgroup
  bf16 a0[2][wg::kWgRows * kMaxK0];  // posenc operand per warpgroup
  wgf::Ring<kStagesK3> ring;         // weight slices
  bf16 dirs[2][wgf::kMaxRays][W / 2];
  float pts[2][wg::kWgRows][3];
  float heads[W * 4];                // σ and rgb heads, or the out head
  float row_sigma[wg::kItemRows];
  float row_rgb[wg::kItemRows][3];
  // the net's biases follow (FieldArgs::n_b floats)
};

struct FieldArgs {
  const float* pts;      // (n, 3)
  const bf16* dirpart;   // (n / spr, width / 2), read only with a view branch
  const bf16* condpart;  // (n / spr, cw) per-ray cond term, or null
  const float* alive;    // (n / tile_rows,) tile flags, or null: all live
  const bf16* w;         // packed weights (Layout): the heads
  const bf16* wp;        // field slices (kernels/wgpack.py)
  const float* b;        // packed biases (Layout)
  float* rgb;            // (n, 3) post-sigmoid
  float* sigma;          // (n,) raw
  int n, spr, L, n_b;
  int cw;                // condpart columns (n_cond·W), 0 without one
  int tile_rows;         // rows of a predication tile (with alive)
  int n_slices;
  int slice_bytes[wgf::kMaxSlices];
  Layout lay;
};

template <int W, bool kCond>
__global__ void __launch_bounds__(wgf::kThreads, 1)
    field_kernel(const __grid_constant__ FieldArgs a) {
  constexpr int kHalf = W / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FieldSmem<W>& s = *reinterpret_cast<FieldSmem<W>*>(smem_raw);
  float* bias = reinterpret_cast<float*>(smem_raw + sizeof(FieldSmem<W>));
  const Layout& lay = a.lay;
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
  __syncthreads();
  const int n_items = (a.n + wg::kItemRows - 1) / wg::kItemRows;

  if (warp >= wgf::kConsumers / 32) {
    wg::setmaxnreg_dec<40>();
    if (warp == wgf::kConsumers / 32 && lane == 0)
      wgf::produce(s.ring, a.wp, a.slice_bytes, a.n_slices, n_items, a.alive,
                   a.tile_rows);
    return;
  }

  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, tw = threadIdx.x & 127, ww = tw >> 5;
  float(*pts)[3] = s.pts[g];
  bf16(*dirs)[kHalf] = s.dirs[g];
  float* row_sigma = s.row_sigma + 64 * g;
  float(*row_rgb)[3] = s.row_rgb + 64 * g;
  wgf::Rows t{s.h[g], s.a0[g], bias, s.heads, pts, nullptr, nullptr,
              row_sigma, row_rgb, nullptr, tw, ww, lane, 1 + g,
              16 * ww + (lane >> 2), 2 * (lane & 3)};
  wgf::RingPos rp{0, 0u, -1};
  float acc[W / 2];

  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const long row0 = (long)it * wg::kItemRows + 64 * g;
    const bool live = row0 < a.n;
    if (!wgf::item_live(a.alive, it, a.tile_rows)) {
      // a dead tile: the sentinel rows, no matrix work, no ring slices
      if (live)
        for (int i = tw; i < 64 * 4; i += 128) {
          const long r = row0 + i / 4;
          if (i % 4 == 3)
            a.sigma[r] = kDeadSigma;
          else
            a.rgb[r * 3 + i % 4] = 0.0f;
        }
      continue;
    }
    for (int i = tw; i < 64 * 3; i += 128)
      pts[i / 3][i % 3] = live ? a.pts[row0 * 3 + i] : 0.0f;
    const long ray0 = row0 / a.spr;
    const int nr = (int)((row0 + 63) / a.spr - ray0 + 1);
    const bool staged = nr <= wgf::kMaxRays;
    if (lay.has_vd && live && staged)
      for (int i = tw; i < nr * kHalf; i += 128)
        dirs[i / kHalf][i % kHalf] = a.dirpart[ray0 * kHalf + i];
    t.dir_lo = t.dir_hi = dirs[0];
    if (lay.has_vd && live) {
      const long q_lo = (row0 + t.rA) / a.spr, q_hi = (row0 + t.rA + 8) / a.spr;
      t.dir_lo = staged ? dirs[q_lo - ray0] : a.dirpart + q_lo * kHalf;
      t.dir_hi = staged ? dirs[q_hi - ray0] : a.dirpart + q_hi * kHalf;
    }
    if (kCond) {
      // a warpgroup without rows reads ray 0's (its outputs are dropped)
      const long q_lo = live ? (row0 + t.rA) / a.spr : 0;
      const long q_hi = live ? (row0 + t.rA + 8) / a.spr : 0;
      t.cond_lo = a.condpart + q_lo * a.cw;
      t.cond_hi = a.condpart + q_hi * a.cw;
    }
    wg::wg_sync(t.bar);
    wgf::posenc_tile(t.A0, lay.k0, a.L, pts, tw);
    wg::fence_async_smem();
    wg::wg_sync(t.bar);

    wgf::forward<W, kCond>(lay, t, s.ring, rp, acc, [](int, int) {}, [] {});

    if (live && tw < 64) {
      a.sigma[row0 + tw] = row_sigma[tw];
      for (int q = 0; q < 3; ++q) a.rgb[(row0 + tw) * 3 + q] = row_rgb[tw][q];
    }
    wg::wg_sync(t.bar);
  }
}

template <int W, bool kCond>
int launch_field(FieldArgs& a, int device, cudaStream_t st) {
  const int smem = (int)sizeof(FieldSmem<W>) + a.n_b * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)field_kernel<W, kCond>, device,
                             smem);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return (int)err;
  if (a.n == 0) return 0;
  const int n_items = (a.n + wg::kItemRows - 1) / wg::kItemRows;
  field_kernel<W, kCond><<<n_items < n_sm ? n_items : n_sm, wgf::kThreads,
                           smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fnt

extern "C" {

// The field on n rows (a multiple of 64 and of spr), width 128 or 256,
// depth 2-8, k0 48 or 64. wp holds the net's field slices
// (kernels/wgpack.py::field_buffer); skip_mask: the skip layers (Layout).
// condpart: null, or (n / spr, cw) bf16
// with cw = W times the layers that take the posenc operand. alive: null,
// or n / tile_rows f32 tile flags, tile_rows a multiple of 128 or n itself.
// device: the operands' CUDA device. Returns a cudaError_t.
int fnt_field_forward(const void* pts, const void* dirpart, const void* w,
                      const void* wp, const void* b, void* rgb, void* sigma,
                      const void* condpart, const void* alive, int cw,
                      int tile_rows, int n, int spr, int L, int depth,
                      int width, int k0, int skip_mask, int has_vd,
                      int device, void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  FieldArgs a;
  a.pts = static_cast<const float*>(pts);
  a.dirpart = static_cast<const bf16*>(dirpart);
  a.w = static_cast<const bf16*>(w);
  a.wp = static_cast<const bf16*>(wp);
  a.b = static_cast<const float*>(b);
  a.rgb = static_cast<float*>(rgb);
  a.sigma = static_cast<float*>(sigma);
  a.condpart = static_cast<const bf16*>(condpart);
  a.alive = static_cast<const float*>(alive);
  a.cw = cw;
  a.tile_rows = tile_rows;
  a.n = n;
  a.spr = spr;
  a.L = L;
  a.lay = make_layout(depth, width, k0, skip_mask, has_vd);
  a.n_b = has_vd ? a.lay.b_rgb + 3 : a.lay.b_out + 4;
  a.n_slices = wgf::field_slice_bytes(a.lay, false, a.slice_bytes);
  if (wgf::field_layout_error(a.lay) || a.n_slices < 0 || n < 0 ||
      n % wg::kWgRows || spr < 1 || n % spr || 3 + 6 * L > k0 ||
      (reinterpret_cast<uintptr_t>(wp) & 15) ||
      (condpart != nullptr) != (cw > 0) ||
      (cw > 0 && (cw != wgf::cond_layers(a.lay) * width ||
                  (reinterpret_cast<uintptr_t>(condpart) & 3))) ||
      (alive != nullptr &&
       (tile_rows < wg::kWgRows || n % tile_rows ||
        (tile_rows % wg::kItemRows && tile_rows != n))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cw > 0)
    return width == 256 ? launch_field<256, true>(a, device, st)
                        : launch_field<128, true>(a, device, st);
  return width == 256 ? launch_field<256, false>(a, device, st)
                      : launch_field<128, false>(a, device, st);
}

// The layout every kernel builds from these arguments, for checking it
// against kernels/posenc_mlp.py::_layout: out takes depth entries each of
// w_h, w_a0 and b, then w_sig, w_feat, w_view, w_rgb, w_out, b_sig,
// b_feat, b_view, b_rgb, b_out (-1 where a tensor is absent). Returns
// layout_error's verdict.
int fnt_layout(int depth, int width, int k0, int skip_mask, int has_vd,
               int* out) {
  using namespace fnt;
  if (depth < 1 || depth > kMaxDepth) return 1;
  const Layout L = make_layout(depth, width, k0, skip_mask, has_vd);
  int n = 0;
  for (int i = 0; i < depth; ++i) out[n++] = L.w_h[i];
  for (int i = 0; i < depth; ++i) out[n++] = L.w_a0[i];
  for (int i = 0; i < depth; ++i) out[n++] = L.b[i];
  const int heads[] = {L.w_sig, L.w_feat, L.w_view, L.w_rgb, L.w_out,
                       L.b_sig, L.b_feat, L.b_view, L.b_rgb, L.b_out};
  for (int v : heads) out[n++] = v;
  return layout_error(L);
}

const char* fnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
