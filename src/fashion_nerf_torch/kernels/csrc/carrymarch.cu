// Generic carry march of a full field (kernel K6), one sample block per
// launch.
//
// Replaces: src/fashion_nerf/kernels/blockmarch_pallas.py::_carry_kernel (via
// _carry_eval), the TPU kernel that marches a field over NB blocks of SB
// samples per ray with the transmittance carry and the rgb, depth and acc
// accumulators held in VMEM across a tile's sequential block programs,
// building each sample's position o + d·t inside the kernel.
//
// What bounds it on the H100: the same bf16 matrix products as K2 (the
// first and skip layers take [x | sin | cos] from the operand instead of a
// hoisted x-path, so 3 more operand columns inside the same padded 64), so
// tensor-core throughput, and in this first version the latency of wmma
// fragment loads from L2; the work it skips (dead tiles) is what a frame's
// time depends on most.
//
// Design: K2's skeleton (csrc/slimmarch.cu) with K3's operand build
// (csrc/field.cu). The wrapper launches this kernel once per sample block b.
// A CUDA block owns one 64-row slab = 64/SB whole rays for block b and
// composites them itself. Predication follows the reference tile of
// 2048/SB rays: the (tile, b) pair runs iff some ray of the tile has
// hit ∧ block_hit[b] ∧ logT > log ε, and then every ray of the tile is
// marched. The decision reads logT_in, written by the previous launch; the
// launch writes logT_out, so no block reads a carry that another block of
// the same launch updates. A dead pair writes w = 0 and carries rgb, depth,
// acc and logT through unchanged. Each row's position is o + d·t in f32
// without contraction (__fmul_rn/__fadd_rn, as the plain version rounds),
// the operand is [bf16(x) | bf16(sin P)] with P = x·2^(j mod L) (+π/2 on
// the cos half) in f32; the view term γ(d)·W_dir arrives per ray. The
// reference's selector-matmul lane gathers and its triangular-matmul prefix
// are TPU workarounds: here t is indexed directly and the exclusive log-T
// prefix is a sequential f32 sum, clamped at log(1e-10) per sample.
#include "fnt_common.cuh"

namespace fnt {

struct CarryArgs {
  const float* hit;        // (R,) AABB hit flags
  const float* block_hit;  // (R, NB) macro-box flags per sample block
  const float* rays_o;     // (R, 3)
  const float* rays_d;     // (R, 3)
  const bf16* dirpart;     // (R, W/2) per-ray view term (view branch only)
  const float* t;          // (R, NB·SB) sample positions
  const float* d;          // (R, NB·SB) scaled interval widths
  const bf16* w;           // packed weights (Layout, x rows in the operand)
  const float* b;          // packed biases
  float* rgb;              // (R, 3) accumulated radiance
  float* depth;            // (R,) accumulated Σ w·t
  float* acc;              // (R,) accumulated Σ w
  float* w_out;            // (R, NB·SB) weights
  const float* logT_in;    // (R,) carry before block b (unused at b = 0)
  float* logT_out;         // (R,) carry after block b
  int NB, SB, blk, L, softplus;
  float log_eps;
  Layout lay;
};

__global__ void __launch_bounds__(kThreads) carry_march_kernel(CarryArgs a) {
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
      if (first) {
        for (int c = 0; c < 3; ++c) a.rgb[ray * 3 + c] = 0.0f;
        a.depth[ray] = 0.0f;
        a.acc[ray] = 0.0f;
      }
    }
    return;
  }

  for (int r = threadIdx.x; r < kRows; r += kThreads)
    s.row_t[r] = a.t[(r0 + r / SB) * S + col0 + r % SB];
  __syncthreads();
  // posenc operand of pts = o + d·t: [x (3) | sin(2^f x) blocks | cos
  // blocks | 0-pad], the cos half as sin(· + π/2) like the field kernel
  const int n_ph = 6 * a.L;
  for (int i = threadIdx.x; i < kRows * lay.k0; i += kThreads) {
    const int r = i / lay.k0, c = i % lay.k0;
    const long ray = r0 + r / SB;
    float v = 0.0f;
    if (c < 3 + n_ph) {
      const int k = c < 3 ? c : (c - 3) % 3;
      const float x = __fadd_rn(a.rays_o[ray * 3 + k],
                                __fmul_rn(a.rays_d[ray * 3 + k], s.row_t[r]));
      if (c < 3) {
        v = x;
      } else {
        const int j = (c - 3) / 3;
        const float f = (float)(1 << (j % a.L));
        const float off = j >= a.L ? kHalfPi : 0.0f;
        v = sinf(__fadd_rn(__fmul_rn(x, f), off));
      }
    }
    s.a0[r * kLdA + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int cur = run_trunk(lay, a.w, a.b,
                            [](int, int, int) { return 0.0f; });
  const int half = lay.width / 2;
  run_heads(lay, a.w, a.b, cur, [&](int r, int c) {
    return bf(a.dirpart[(r0 + r / SB) * half + c]);
  });

  if (threadIdx.x < nr) {
    const int j = threadIdx.x;
    const long ray = r0 + j;
    const float lt = first ? 0.0f : a.logT_in[ray];
    float csum = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f,
          ac = 0.0f;
    for (int k = 0; k < SB; ++k) {
      const int r = j * SB + k;
      const float x = __fmul_rn(density(s.row_sigma[r], a.softplus),
                                a.d[ray * S + col0 + k]);
      const float wk = __fmul_rn(1.0f - expf(-x), expf(lt + csum));
      a.w_out[ray * S + col0 + k] = wk;
      c0 += wk * s.row_rgb[r][0];
      c1 += wk * s.row_rgb[r][1];
      c2 += wk * s.row_rgb[r][2];
      dep += wk * s.row_t[r];
      ac += wk;
      csum += fmaxf(-x, kLogFloor);
    }
    a.rgb[ray * 3 + 0] = (first ? 0.0f : a.rgb[ray * 3 + 0]) + c0;
    a.rgb[ray * 3 + 1] = (first ? 0.0f : a.rgb[ray * 3 + 1]) + c1;
    a.rgb[ray * 3 + 2] = (first ? 0.0f : a.rgb[ray * 3 + 2]) + c2;
    a.depth[ray] = (first ? 0.0f : a.depth[ray]) + dep;
    a.acc[ray] = (first ? 0.0f : a.acc[ray]) + ac;
    a.logT_out[ray] = lt + csum;
  }
}

}  // namespace fnt

extern "C" {

// Marches sample block `blk` of NB. R must be a multiple of the tile
// (2048/SB rays); SB must divide 64. Returns a cudaError_t.
int fnt_carry_march(const void* hit, const void* block_hit,
                    const void* rays_o, const void* rays_d,
                    const void* dirpart, const void* t, const void* d,
                    const void* w, const void* b, void* rgb, void* depth,
                    void* acc, void* w_out, const void* logT_in,
                    void* logT_out, int R, int NB, int SB, int blk, int L,
                    int depth_layers, int width, int k0, int skip,
                    int has_vd, int softplus, float log_eps, void* stream) {
  using namespace fnt;
  CarryArgs a;
  a.hit = static_cast<const float*>(hit);
  a.block_hit = static_cast<const float*>(block_hit);
  a.rays_o = static_cast<const float*>(rays_o);
  a.rays_d = static_cast<const float*>(rays_d);
  a.dirpart = static_cast<const bf16*>(dirpart);
  a.t = static_cast<const float*>(t);
  a.d = static_cast<const float*>(d);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const float*>(b);
  a.rgb = static_cast<float*>(rgb);
  a.depth = static_cast<float*>(depth);
  a.acc = static_cast<float*>(acc);
  a.w_out = static_cast<float*>(w_out);
  a.logT_in = static_cast<const float*>(logT_in);
  a.logT_out = static_cast<float*>(logT_out);
  a.NB = NB;
  a.SB = SB;
  a.blk = blk;
  a.L = L;
  a.softplus = softplus;
  a.log_eps = log_eps;
  a.lay = make_layout(depth_layers, width, k0, skip, has_vd);
  if (layout_error(a.lay) || SB < 1 || kRows % SB || 3 + 6 * L > k0 ||
      R % (kTileRows / SB) || blk < 0 || blk >= NB)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(carry_march_kernel);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return 0;
  carry_march_kernel<<<R / (kRows / SB), kThreads, sizeof(Smem),
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
