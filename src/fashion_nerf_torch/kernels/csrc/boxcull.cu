// Occupancy culling of a chunk's rays against the macro boxes (kernel K8).
//
// Replaces: no TPU kernel. The reference culls in XLA glue,
// src/fashion_nerf/core/occupancy.py::ray_multi_aabb and
// src/fashion_nerf/render/blockwise.py::_block_hit_flags, which XLA fuses
// into its own loops. Run eagerly in torch, the same ops write and read
// back one (R, K) f32 tensor each (134 MB at 65,536 rays and K = 512
// boxes), and (R, NB, K) broadcasts for the per-block overlap: ~10 GB of
// device traffic a chunk whose real inputs and outputs are ~3 MB. K8 is
// that composition with the intermediates kept in registers.
//
// What bounds it on the H100: f32 instruction issue. A (ray, occupied box)
// pair costs ~28 f32 instructions (the slab test's 6 subtractions and 6
// multiplications, the per-axis min and max, the reductions over the axes,
// the clamp to [near, far], the hit test) against 24 bytes of ray read
// once; block_hit adds its blocks' sample ranges, read once.
//
// Design: one thread a ray. The wrapper takes the occupied boxes only,
// compacted once an image with the nets' packing (core/occupancy.py::
// occupied_boxes: the state is fixed for a frame, 46 of the flagship's 512
// boxes are occupied), so the loop runs over them alone. Each CUDA block
// stages them in shared memory, kStage at a time. `box_cull` keeps the
// union interval and the hit flag (mins, maxes and ors over the boxes,
// exact in any order); `block_hit` reads its ray's block ranges [first
// sample, max over the block] kGroup at a time into registers, recomputes
// each box's clamped segment and ors the overlaps into a bit mask,
// stopping early once every block of the group is flagged.
//
// Numerics: the same f32 operations in torch's order, (b − o)·inv with
// __fsub_rn/__fmul_rn (nothing to contract into an FMA), fminf/fmaxf on
// finite values, so the outputs equal the plain versions' (inputs are
// finite: `_safe_inv` bounds every reciprocal by 1e10). Build without
// --use_fast_math.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "fnt_common.cuh"

namespace fnt {
namespace {

constexpr int kThreads = 128;    // rays a CUDA block
constexpr int kStage = 512;      // boxes staged in shared memory at a time
constexpr int kGroup = 4;        // a ray's blocks held in registers at a time

struct Boxes {
  const float* lo;               // (K, 3), occupied boxes only
  const float* hi;               // (K, 3)
  int K;
};

struct Ray {
  float ox, oy, oz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* inv,
                                        long r) {
  return Ray{o[3 * r], o[3 * r + 1], o[3 * r + 2],
             inv[3 * r], inv[3 * r + 1], inv[3 * r + 2]};
}

// Stages boxes [k0, k0 + kStage) in lo_s/hi_s → their count. Every thread
// of the block calls it (it synchronises).
__device__ int stage_boxes(const Boxes& b, int k0, float4* lo_s,
                           float4* hi_s) {
  __syncthreads();               // the previous stage is read
  const int n = min(b.K - k0, kStage);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = k0 + i;
    lo_s[i] = make_float4(b.lo[3 * k], b.lo[3 * k + 1], b.lo[3 * k + 2],
                          0.0f);
    hi_s[i] = make_float4(b.hi[3 * k], b.hi[3 * k + 1], b.hi[3 * k + 2],
                          0.0f);
  }
  __syncthreads();
  return n;
}

__device__ __forceinline__ void slab(float b_lo, float b_hi, float o,
                                     float inv, float* t_lo, float* t_hi) {
  const float t0 = __fmul_rn(__fsub_rn(b_lo, o), inv);
  const float t1 = __fmul_rn(__fsub_rn(b_hi, o), inv);
  *t_lo = fminf(t0, t1);
  *t_hi = fmaxf(t0, t1);
}

// The ray's segment [lo, hi] in one box, clamped to [near, far]:
// ray_multi_aabb's seg_lo and seg_hi (its seg_hit is hi > lo).
__device__ __forceinline__ void segment(const Ray& r, float4 bl, float4 bh,
                                        float near, float far, float* lo,
                                        float* hi) {
  float tn, tf, a, b;
  slab(bl.x, bh.x, r.ox, r.ix, &tn, &tf);
  slab(bl.y, bh.y, r.oy, r.iy, &a, &b);
  tn = fmaxf(tn, a);
  tf = fminf(tf, b);
  slab(bl.z, bh.z, r.oz, r.iz, &a, &b);
  tn = fmaxf(tn, a);
  tf = fminf(tf, b);
  *lo = fminf(fmaxf(tn, near), far);
  *hi = fminf(fmaxf(tf, near), far);
}

__global__ void __launch_bounds__(kThreads)
box_cull_kernel(const float* __restrict__ o, const float* __restrict__ inv,
                Boxes b, float near, float far, float* near_out,
                float* far_out, uint8_t* hit_out, int R) {
  __shared__ float4 lo_s[kStage];
  __shared__ float4 hi_s[kStage];
  const long r = (long)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = r < R;
  const Ray ray = load_ray(o, inv, valid ? r : 0);
  float t_lo = far, t_hi = near;
  bool any = false;
  for (int k0 = 0; k0 < b.K; k0 += kStage) {
    const int n = stage_boxes(b, k0, lo_s, hi_s);
    for (int i = 0; i < n; ++i) {
      float lo, hi;
      segment(ray, lo_s[i], hi_s[i], near, far, &lo, &hi);
      if (hi > lo) {
        t_lo = fminf(t_lo, lo);
        t_hi = fmaxf(t_hi, hi);
        any = true;
      }
    }
  }
  if (valid) {
    near_out[r] = any ? t_lo : far;
    far_out[r] = any ? t_hi : far;
    hit_out[r] = any ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
block_hit_kernel(const float* __restrict__ t, const float* __restrict__ o,
                 const float* __restrict__ inv, Boxes b, float near,
                 float far, float* flags, int R, int NB, int SB) {
  __shared__ float4 lo_s[kStage];
  __shared__ float4 hi_s[kStage];
  const long r = (long)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = r < R;
  const Ray ray = load_ray(o, inv, valid ? r : 0);
  const float* tr = t + (valid ? r : 0) * (long)NB * SB;
  for (int g0 = 0; g0 < NB; g0 += kGroup) {
    float ts[kGroup], te[kGroup];
    unsigned want = 0;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      ts[j] = CUDART_INF_F;      // past NB: overlaps nothing
      te[j] = -CUDART_INF_F;
      if (g0 + j < NB) {
        const float* tb = tr + (long)(g0 + j) * SB;
        float m = tb[0];
        ts[j] = m;
        for (int s = 1; s < SB; ++s) m = fmaxf(m, tb[s]);
        te[j] = m;
        want |= 1u << j;
      }
    }
    unsigned bits = 0;
    for (int k0 = 0; k0 < b.K; k0 += kStage) {
      const int n = stage_boxes(b, k0, lo_s, hi_s);
      for (int i = 0; i < n && bits != want; ++i) {
        float lo, hi;
        segment(ray, lo_s[i], hi_s[i], near, far, &lo, &hi);
        if (hi > lo) {
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            bits |= (unsigned)((lo <= te[j]) & (hi >= ts[j])) << j;
        }
      }
    }
    if (valid) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (g0 + j < NB)
          flags[r * NB + g0 + j] = ((bits >> j) & 1u) ? 1.0f : 0.0f;
    }
  }
}

}  // namespace
}  // namespace fnt

extern "C" {

// rays_o, inv_d (R,3) f32; boxes_min, boxes_max (K,3) f32, the occupied
// boxes → near_out, far_out (R,) f32, hit_out (R,) bool: ray_multi_aabb's
// union interval (far, far on a miss) and hit. All contiguous, on
// `device`. Returns a cudaError_t.
int fnt_box_cull(const void* rays_o, const void* inv_d,
                 const void* boxes_min, const void* boxes_max,
                 void* near_out, void* far_out, void* hit_out, int R, int K,
                 float near, float far, int device, void* stream) {
  fnt::DeviceGuard on(device);
  if (on.error()) return on.error();
  if (R < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const fnt::Boxes b{static_cast<const float*>(boxes_min),
                     static_cast<const float*>(boxes_max), K};
  const int blocks = (R + fnt::kThreads - 1) / fnt::kThreads;
  fnt::box_cull_kernel<<<blocks, fnt::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(inv_d), b,
      near, far, static_cast<float*>(near_out), static_cast<float*>(far_out),
      static_cast<uint8_t*>(hit_out), R);
  return (int)cudaGetLastError();
}

// t_pad (R, NB·SB) f32 and the box_cull inputs → flags (R, NB) f32: 1 where
// block b's range [t_pad[r, b·SB], max of its SB samples] overlaps a box the
// ray hits (_block_hit_flags of ray_multi_aabb's segments). All contiguous,
// on `device`. Returns a cudaError_t.
int fnt_block_hit(const void* t_pad, const void* rays_o, const void* inv_d,
                  const void* boxes_min, const void* boxes_max, void* flags,
                  int R, int NB, int SB, int K, float near, float far,
                  int device, void* stream) {
  fnt::DeviceGuard on(device);
  if (on.error()) return on.error();
  if (R < 0 || NB < 1 || SB < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const fnt::Boxes b{static_cast<const float*>(boxes_min),
                     static_cast<const float*>(boxes_max), K};
  const int blocks = (R + fnt::kThreads - 1) / fnt::kThreads;
  fnt::block_hit_kernel<<<blocks, fnt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_pad), static_cast<const float*>(rays_o),
      static_cast<const float*>(inv_d), b, near, far,
      static_cast<float*>(flags), R, NB, SB);
  return (int)cudaGetLastError();
}

}  // extern "C"
