// Fused volume render of per-sample (rgb, σ) along rays (kernel K5).
//
// Replaces: src/fashion_nerf/kernels/render_pallas.py::_render_kernel (via
// _fused_volrend / fused_render_rays), the TPU kernel that composites a
// 256-ray tile in VMEM with the exclusive log-transmittance scan done as a
// strict-upper-triangular matmul over a 128-lane-padded sample axis.
//
// What bounds it on the H100: device memory. A ray reads 5 floats and
// writes 1 per sample (rgb, σ, t in; weight out) for ~10 flops and one
// exp, far below the ridge; the kernel streams each ray once.
//
// Design: one warp per ray, any sample count S. The warp walks the samples
// 32 at a time: δ (the last one 1e10) times ‖d‖, α = 1 − exp(−relu(σ)·δ),
// log(1−α) as max(−σδ, −23.025851) (the reference's floor, log 1e-10), an
// exclusive warp-shuffle scan of it plus the carry of the earlier groups,
// w = α·exp(log T); then warp sums of w·rgb, w·t and w. The TPU padding and
// the triangular matmul have no counterpart here.
#include <cuda_runtime.h>

#include "fnt_common.cuh"

namespace {

constexpr int kRaysPerBlock = 8;
constexpr float kInfDist = 1e10f;
constexpr float kLogFloor = -23.025851f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kRaysPerBlock)
volrend_kernel(const float* __restrict__ rgb, const float* __restrict__ sigma,
               const float* __restrict__ t, const float* __restrict__ dnorm,
               float* rgb_out, float* depth, float* acc, float* weights,
               int R, int S, int white, int softplus) {
  const int lane = threadIdx.x & 31;
  const long ray = (long)blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;
  const float dn = dnorm[ray];
  const float* tr = t + ray * S;
  float carry = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f, sd = 0.0f, sa = 0.0f;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool valid = i < S;
    float ti = 0.0f, lo = 0.0f, alpha = 0.0f;
    if (valid) {
      ti = tr[i];
      const float dist =
          (i + 1 < S ? __fsub_rn(tr[i + 1], ti) : kInfDist) * dn;
      const float s = sigma[ray * S + i];
      const float dens = softplus ? (s > 20.0f ? s : log1pf(expf(s)))
                                  : fmaxf(s, 0.0f);
      const float x = dens * dist;
      alpha = 1.0f - expf(-x);
      lo = fmaxf(-x, kLogFloor);
    }
    // inclusive scan of lo over the group, then shift by one lane
    float incl = lo;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float w = alpha * expf(carry + excl);
    carry += __shfl_sync(0xffffffffu, incl, 31);
    if (valid) {
      const float* c = rgb + (ray * S + i) * 3;
      sr = fmaf(w, c[0], sr);
      sg = fmaf(w, c[1], sg);
      sb = fmaf(w, c[2], sb);
      sd = fmaf(w, ti, sd);
      sa += w;
      weights[ray * S + i] = w;
    }
  }
  sr = warp_sum(sr); sg = warp_sum(sg); sb = warp_sum(sb);
  sd = warp_sum(sd); sa = warp_sum(sa);
  if (lane == 0) {
    const float bg = white ? 1.0f - sa : 0.0f;
    rgb_out[ray * 3 + 0] = sr + bg;
    rgb_out[ray * 3 + 1] = sg + bg;
    rgb_out[ray * 3 + 2] = sb + bg;
    depth[ray] = sd;
    acc[ray] = sa;
  }
}

}  // namespace

extern "C" {

// rgb (R,S,3), sigma/t (R,S), dnorm (R,) → rgb_out (R,3), depth/acc (R,),
// weights (R,S); all f32 and contiguous; device: their CUDA device.
// Returns a cudaError_t.
int fnt_volrend(const void* rgb, const void* sigma, const void* t,
                const void* dnorm, void* rgb_out, void* depth, void* acc,
                void* weights, int R, int S, int white, int softplus,
                int device, void* stream) {
  fnt::DeviceGuard on(device);
  if (on.error()) return on.error();
  if (R < 0 || S < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int blocks = (R + kRaysPerBlock - 1) / kRaysPerBlock;
  volrend_kernel<<<blocks, 32 * kRaysPerBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(sigma),
      static_cast<const float*>(t), static_cast<const float*>(dnorm),
      static_cast<float*>(rgb_out), static_cast<float*>(depth),
      static_cast<float*>(acc), static_cast<float*>(weights), R, S, white,
      softplus);
  return (int)cudaGetLastError();
}

}  // extern "C"
