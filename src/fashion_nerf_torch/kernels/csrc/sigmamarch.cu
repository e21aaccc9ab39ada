// σ-only single-block proposal march (kernel K1).
//
// Replaces: src/fashion_nerf/kernels/sigmamarch_pallas.py::_sigma_kernel
// (via _sigma_march_eval), the TPU kernel that marches the 2x128 σ-only
// proposal net over one block of SB samples per ray.
//
// What bounds it on the H100: it is a small net (~24k MACs per row), so it
// is bound by latency: the per-row posenc sines, the short layer chain and
// the per-ray prefix scan, not by tensor-core throughput or bytes.
//
// Design: one CUDA block per 64-row slab = 64/SB whole rays (one ray at
// SB=64), so every block finishes its own rays' compositing without any
// cross-block carry, and a frame chunk launches thousands of independent
// blocks to hide latency. The first layer's x-path and the posenc phases
// are linear in t and arrive hoisted per ray (oWx + dWx·t, oF + dF·t, f32).
// Predication follows the reference tile: a tile of 2048/SB rays is marched
// when any of its rays is alive, and every ray of a live tile is marched
// (alive or not); a dead tile writes w = 0, acc = 0, logT = 0. Each block
// takes its tile's decision from the tile's alive flags. The exclusive
// log-transmittance prefix is a sequential f32 loop per ray.
#include "fnt_common.cuh"

namespace fnt {

struct SigmaArgs {
  const float* alive;   // (R,) hit ∧ block-hit flags
  const float* oWx;     // (R, W) first-layer x intercept (bias folded)
  const float* dWx;     // (R, W) first-layer x slope
  const float* oF;      // (R, 6L) phase intercept (π/2 offset folded)
  const float* dF;      // (R, 6L) phase slope
  const float* t;       // (R, SB) sample positions
  const float* d;       // (R, SB) scaled interval widths
  const bf16* w;        // packed weights (Layout, no view branch)
  const float* b;       // packed biases (first-layer bias is 0: hoisted)
  float* w_out;         // (R, SB)
  float* acc;           // (R,)
  float* logT;          // (R,)
  int SB, L, softplus;
  Layout lay;
};

__global__ void __launch_bounds__(kThreads) sigma_march_kernel(SigmaArgs a) {
  Smem& s = smem();
  const Layout& lay = a.lay;
  const int SB = a.SB;
  const int nr = kRows / SB;              // rays in this slab
  const long r0 = (long)blockIdx.x * nr;  // first ray of the slab
  const int rpt = kTileRows / SB;         // rays per predication tile
  const long tile0 = (r0 / rpt) * rpt;

  int live = 0;
  for (int i = threadIdx.x; i < rpt; i += kThreads)
    live |= a.alive[tile0 + i] > 0.0f;
  live = __syncthreads_or(live);
  if (!live) {
    for (int i = threadIdx.x; i < nr * SB; i += kThreads)
      a.w_out[r0 * SB + i] = 0.0f;
    if (threadIdx.x < nr) {
      a.acc[r0 + threadIdx.x] = 0.0f;
      a.logT[r0 + threadIdx.x] = 0.0f;
    }
    return;
  }

  for (int r = threadIdx.x; r < kRows; r += kThreads)
    s.row_t[r] = a.t[r0 * SB + r];
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
  const int cur = run_trunk(lay, a.w, a.b, [&](int, int r, int c) {
    const long q = (r0 + r / SB) * W + c;
    return __fadd_rn(a.oWx[q], __fmul_rn(a.dWx[q], s.row_t[r]));
  });
  run_heads(lay, a.w, a.b, cur, [](int, int) { return 0.0f; });

  if (threadIdx.x < nr) {
    const int j = threadIdx.x;
    const long ray = r0 + j;
    float csum = 0.0f, acc = 0.0f;
    for (int k = 0; k < SB; ++k) {
      const float x = __fmul_rn(density(s.row_sigma[j * SB + k], a.softplus),
                                a.d[ray * SB + k]);
      const float wk = __fmul_rn(1.0f - expf(-x), expf(csum));
      a.w_out[ray * SB + k] = wk;
      acc += wk;
      csum += fmaxf(-x, kLogFloor);
    }
    a.acc[ray] = acc;
    a.logT[ray] = csum;
  }
}

}  // namespace fnt

extern "C" {

// R must be a multiple of the tile (2048/SB rays); SB must divide 64.
// Returns a cudaError_t.
int fnt_sigma_march(const void* alive, const void* oWx, const void* dWx,
                    const void* oF, const void* dF, const void* t,
                    const void* d, const void* w, const void* b, void* w_out,
                    void* acc, void* logT, int R, int SB, int L, int depth,
                    int width, int k0, int softplus, void* stream) {
  using namespace fnt;
  SigmaArgs a;
  a.alive = static_cast<const float*>(alive);
  a.oWx = static_cast<const float*>(oWx);
  a.dWx = static_cast<const float*>(dWx);
  a.oF = static_cast<const float*>(oF);
  a.dF = static_cast<const float*>(dF);
  a.t = static_cast<const float*>(t);
  a.d = static_cast<const float*>(d);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const float*>(b);
  a.w_out = static_cast<float*>(w_out);
  a.acc = static_cast<float*>(acc);
  a.logT = static_cast<float*>(logT);
  a.SB = SB;
  a.L = L;
  a.softplus = softplus;
  a.lay = make_layout(depth, width, k0, -1, 0);
  if (layout_error(a.lay) || SB < 1 || kRows % SB || 6 * L > k0 ||
      R % (kTileRows / SB))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(sigma_march_kernel);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return 0;
  sigma_march_kernel<<<R / (kRows / SB), kThreads, sizeof(Smem),
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
