// Multi-block fine march of the 8x256 field (kernel K2), one sample block
// per launch.
//
// Replaces: src/fashion_nerf/kernels/slimmarch_pallas.py::_slim_kernel (via
// _slim_eval), the TPU kernel that marches the fine field over NB blocks of
// SB samples per ray with the transmittance carry and the rgb accumulator
// held in VMEM across a tile's sequential block programs.
//
// What bounds it on the H100: bf16 matrix products (~0.59M MACs per row
// against a few bytes of per-row input), so tensor-core throughput, and in
// this first version the latency of wmma fragment loads from L2; the work it
// skips (dead tiles) is what the frame time depends on most.
//
// Design: the wrapper launches this kernel once per sample block b. A CUDA
// block owns one 64-row slab = 64/SB whole rays (two rays at SB=32) for
// block b, so it composites its own rays without any cross-block carry
// inside a launch. Predication follows the reference tile of 2048/SB rays:
// the (tile, b) pair runs iff some ray of the tile has hit ∧ block_hit[b] ∧
// logT > log ε, and then every ray of the tile is marched. Each CUDA block
// takes its tile's decision from logT_in, written by the previous launch;
// the launch writes logT_out, a separate buffer, so no block reads a carry
// that another block of the same launch is updating. A dead (tile, b)
// writes w = 0 and carries rgb and logT through unchanged. The first and
// skip layers' x-paths and the posenc phases arrive hoisted per ray
// (oX + dX·t, oF + dF·t, f32); the view term γ(d)·W_dir arrives per ray.
#include "fnt_common.cuh"

namespace fnt {

struct SlimArgs {
  const float* hit;        // (R,) AABB hit flags
  const float* block_hit;  // (R, NB) macro-box flags per sample block
  const float* oX;         // (R, n_x·W) x-layer intercepts (bias folded)
  const float* dX;         // (R, n_x·W) x-layer slopes
  const float* oF;         // (R, 6L) phase intercepts (π/2 folded)
  const float* dF;         // (R, 6L) phase slopes
  const bf16* dirpart;     // (R, W/2) per-ray view term
  const float* t;          // (R, NB·SB) sample positions
  const float* d;          // (R, NB·SB) scaled interval widths
  const bf16* w;           // packed weights (Layout)
  const float* b;          // packed biases (x-layer biases are 0: hoisted)
  float* rgb;              // (R, 3) accumulated radiance
  float* w_out;            // (R, NB·SB) weights
  const float* logT_in;    // (R,) carry before block b (unused at b = 0)
  float* logT_out;         // (R,) carry after block b
  int NB, SB, blk, L, softplus;
  float log_eps;
  Layout lay;
};

__global__ void __launch_bounds__(kThreads) slim_march_kernel(SlimArgs a) {
  Smem& s = smem();
  const Layout& lay = a.lay;
  const int SB = a.SB, S = a.NB * a.SB;
  const int nr = kRows / SB;              // rays in this slab
  const long r0 = (long)blockIdx.x * nr;  // first ray of the slab
  const int rpt = kTileRows / SB;         // rays per predication tile
  const long tile0 = (r0 / rpt) * rpt;
  const bool first = a.blk == 0;
  const long col0 = (long)a.blk * SB;     // first sample column of block b

  if (!tile_alive(a.hit, a.block_hit, a.logT_in, tile0, rpt, a.NB, a.blk,
                  a.log_eps)) {
    for (int i = threadIdx.x; i < nr * SB; i += kThreads)
      a.w_out[(r0 + i / SB) * S + col0 + i % SB] = 0.0f;
    if (threadIdx.x < nr) {
      const long ray = r0 + threadIdx.x;
      a.logT_out[ray] = first ? 0.0f : a.logT_in[ray];
      if (first)
        for (int c = 0; c < 3; ++c) a.rgb[ray * 3 + c] = 0.0f;
    }
    return;
  }

  for (int r = threadIdx.x; r < kRows; r += kThreads)
    s.row_t[r] = a.t[(r0 + r / SB) * S + col0 + r % SB];
  __syncthreads();
  const int n_ph = 6 * a.L;
  for (int i = threadIdx.x; i < kRows * lay.k0; i += kThreads) {
    const int r = i / lay.k0, c = i % lay.k0;
    float v = 0.0f;
    if (c < n_ph) {
      const long q = (r0 + r / SB) * n_ph + c;
      v = sinf(__fadd_rn(a.oF[q], __fmul_rn(a.dF[q], s.row_t[r])));
    }
    s.a0[r * kLdA + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int W = lay.width;
  const int xw = (lay.skip >= 0 ? 2 : 1) * W;   // row stride of oX / dX
  const int cur = run_trunk(lay, a.w, a.b, [&](int l, int r, int c) {
    const long q = (r0 + r / SB) * xw + l * W + c;
    return __fadd_rn(a.oX[q], __fmul_rn(a.dX[q], s.row_t[r]));
  });
  const int half = W / 2;
  run_heads(lay, a.w, a.b, cur, [&](int r, int c) {
    return bf(a.dirpart[(r0 + r / SB) * half + c]);
  });

  if (threadIdx.x < nr) {
    const int j = threadIdx.x;
    const long ray = r0 + j;
    const float lt = first ? 0.0f : a.logT_in[ray];
    float csum = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    for (int k = 0; k < SB; ++k) {
      const int r = j * SB + k;
      const float x = __fmul_rn(density(s.row_sigma[r], a.softplus),
                                a.d[ray * S + col0 + k]);
      const float wk = __fmul_rn(1.0f - expf(-x), expf(lt + csum));
      a.w_out[ray * S + col0 + k] = wk;
      c0 += wk * s.row_rgb[r][0];
      c1 += wk * s.row_rgb[r][1];
      c2 += wk * s.row_rgb[r][2];
      csum += fmaxf(-x, kLogFloor);
    }
    const float* prev = a.rgb + ray * 3;
    a.rgb[ray * 3 + 0] = (first ? 0.0f : prev[0]) + c0;
    a.rgb[ray * 3 + 1] = (first ? 0.0f : prev[1]) + c1;
    a.rgb[ray * 3 + 2] = (first ? 0.0f : prev[2]) + c2;
    a.logT_out[ray] = lt + csum;
  }
}

}  // namespace fnt

extern "C" {

// Marches sample block `blk` of NB. R must be a multiple of the tile
// (2048/SB rays); SB must divide 64. Returns a cudaError_t.
int fnt_slim_march(const void* hit, const void* block_hit, const void* oX,
                   const void* dX, const void* oF, const void* dF,
                   const void* dirpart, const void* t, const void* d,
                   const void* w, const void* b, void* rgb, void* w_out,
                   const void* logT_in, void* logT_out, int R, int NB,
                   int SB, int blk, int L, int depth, int width, int k0,
                   int skip, int softplus, float log_eps, void* stream) {
  using namespace fnt;
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
  a.b = static_cast<const float*>(b);
  a.rgb = static_cast<float*>(rgb);
  a.w_out = static_cast<float*>(w_out);
  a.logT_in = static_cast<const float*>(logT_in);
  a.logT_out = static_cast<float*>(logT_out);
  a.NB = NB;
  a.SB = SB;
  a.blk = blk;
  a.L = L;
  a.softplus = softplus;
  a.log_eps = log_eps;
  a.lay = make_layout(depth, width, k0, skip, 1);
  if (layout_error(a.lay) || SB < 1 || kRows % SB || 6 * L > k0 ||
      R % (kTileRows / SB) || blk < 0 || blk >= NB)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(slim_march_kernel);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return 0;
  slim_march_kernel<<<R / (kRows / SB), kThreads, sizeof(Smem),
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
