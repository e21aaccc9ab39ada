// Shared host and device code of the field kernels: the packed-weight
// layout and the numerics helpers. The layer loop itself (wgmma, the weight
// ring, the compositing scans) is in wg_trunk.cuh and wg_field.cuh; every
// kernel with matrix products runs on it (sigmamarch.cu, slimmarch.cu,
// field.cu, field_bwd.cu, carrymarch.cu, tcprobe.cu).
//
// Numerics follow the reference kernels: every matrix product takes bf16
// operands (rounded to nearest even) and accumulates in f32 on the tensor
// cores; activations are rounded back to bf16 after the relu; posenc
// phases, hoisted per-ray terms and the transmittance prefix stay f32.
// Products that must not be contracted into an FMA (so that the plain
// PyTorch version rounds the same way) use __fmul_rn/__fadd_rn. Build
// without --use_fast_math: phases reach 2^9·|x| ≈ 1e3 rad, where the fast
// __sinf is wrong.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace fnt {

// ---- the device a launch runs on ------------------------------------------
// The library links nvcc's static CUDA runtime. A runtime's current device
// is the calling thread's current driver context, which torch's runtime
// reads too. Every extern "C" entry that launches takes the ordinal of its
// operands' device, makes it current for the call (DeviceGuard) and gives
// the thread's device back at its end, so torch's current device does not
// move. The facts a launch needs from that device (its SM count, a
// kernel's dynamic shared memory limit, its occupancy) are asked once per
// device and kept here: cudaFuncSetAttribute acts on the current device
// only.

// `device` current from construction to destruction; error() is 0 or the
// cudaError_t of making it current.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    if (device < 0) {
      err_ = cudaErrorInvalidDevice;
      return;
    }
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      moved_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (moved_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  int error() const { return (int)err_; }

 private:
  cudaError_t err_ = cudaSuccess;
  int prev_ = 0;
  bool moved_ = false;
};

struct DeviceFacts {
  std::mutex mu;
  std::map<int, int> n_sm;                                     // device →
  std::map<std::tuple<const void*, int>, int> smem;            // set bytes
  std::map<std::tuple<const void*, int, int, int>, int> occ;   // per SM
};

inline DeviceFacts& device_facts() {
  static DeviceFacts f;
  return f;
}

// The SM count of `device`, asked once.
inline cudaError_t sm_count(int device, int* n_sm) {
  DeviceFacts& f = device_facts();
  std::lock_guard<std::mutex> lock(f.mu);
  auto it = f.n_sm.find(device);
  if (it == f.n_sm.end()) {
    int n = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    it = f.n_sm.emplace(device, n).first;
  }
  *n_sm = it->second;
  return cudaSuccess;
}

// Sets `kernel`'s dynamic shared memory limit on `device`, the current one,
// to `bytes` unless the last call for this kernel and device set the same.
inline cudaError_t set_smem(const void* kernel, int device, int bytes) {
  DeviceFacts& f = device_facts();
  std::lock_guard<std::mutex> lock(f.mu);
  const auto key = std::make_tuple(kernel, device);
  auto it = f.smem.find(key);
  if (it != f.smem.end() && it->second == bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) f.smem[key] = bytes;
  return err;
}

// Resident blocks per SM of `kernel` at `threads` and `smem` bytes on
// `device`, the current one, asked once (after set_smem).
inline cudaError_t blocks_per_sm(const void* kernel, int device, int threads,
                                 int smem, int* per_sm) {
  DeviceFacts& f = device_facts();
  std::lock_guard<std::mutex> lock(f.mu);
  const auto key = std::make_tuple(kernel, device, threads, smem);
  auto it = f.occ.find(key);
  if (it == f.occ.end()) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    it = f.occ.emplace(key, n).first;
  }
  *per_sm = it->second;
  return cudaSuccess;
}

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // MLP rows of one warpgroup's tile
constexpr int kMaxWidth = 256;
constexpr int kMaxDepth = 16;
constexpr int kMaxK0 = 64;            // padded width of the posenc operand
constexpr int kTileRows = 2048;       // rows of one predication tile
constexpr float kLogFloor = -23.025851f;   // log(1e-10) floor on log(1-α)
constexpr float kHalfPi = 1.57079632679489661923f;  // == float32(pi / 2)

// Offsets (in elements) of every tensor in the flat bf16 weight buffer and
// the flat f32 bias buffer. Must equal kernels/posenc_mlp.py::_layout.
// skip_mask: bit i set for each layer i > 0 that takes the posenc operand
// beside the activations (a skip layer; the reference's plan has a "skip"
// entry for each), packed as its h-kernel and then its posenc kernel.
struct Layout {
  int depth, width, k0, skip_mask, has_vd;
  int w_h[kMaxDepth];    // h-kernel of layer i (width x width), -1 if none
  int w_a0[kMaxDepth];   // posenc-operand kernel of layer i (k0 x width), -1
  int b[kMaxDepth];      // bias of layer i (width)
  int w_sig, w_feat, w_view, w_rgb, w_out;
  int b_sig, b_feat, b_view, b_rgb, b_out;
};

inline Layout make_layout(int depth, int width, int k0, int skip_mask,
                          int has_vd) {
  Layout L{};
  L.depth = depth; L.width = width; L.k0 = k0; L.skip_mask = skip_mask;
  L.has_vd = has_vd;
  int wo = 0, bo = 0;
  for (int i = 0; i < depth; ++i) {
    L.w_h[i] = -1; L.w_a0[i] = -1;
    if (i == 0) {
      L.w_a0[i] = wo; wo += k0 * width;
    } else if ((skip_mask >> i) & 1) {
      L.w_h[i] = wo; wo += width * width;
      L.w_a0[i] = wo; wo += k0 * width;
    } else {
      L.w_h[i] = wo; wo += width * width;
    }
    L.b[i] = bo; bo += width;
  }
  L.w_sig = L.w_feat = L.w_view = L.w_rgb = L.w_out = -1;
  L.b_sig = L.b_feat = L.b_view = L.b_rgb = L.b_out = -1;
  if (has_vd) {
    L.w_sig = wo; wo += width;
    L.w_feat = wo; wo += width * width;
    L.w_view = wo; wo += width * (width / 2);
    L.w_rgb = wo; wo += (width / 2) * 3;
    L.b_sig = bo; bo += 1;
    L.b_feat = bo; bo += width;
    L.b_view = bo; bo += width / 2;
    L.b_rgb = bo; bo += 3;
  } else {
    L.w_out = wo; wo += width * 4;
    L.b_out = bo; bo += 4;
  }
  return L;
}

// Checks a layout the kernels can index; 0 if fine.
inline int layout_error(const Layout& L) {
  if (L.depth < 1 || L.depth > kMaxDepth) return 1;
  if ((L.skip_mask & 1) || (L.skip_mask >> L.depth)) return 1;
  if (L.width < 16 || L.width > kMaxWidth || L.width % 32) return 1;
  if (L.k0 < 16 || L.k0 > kMaxK0 || L.k0 % 16) return 1;
  return 0;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float density(float sigma, int softplus) {
  if (softplus) return sigma > 20.0f ? sigma : log1pf(expf(sigma));
  return fmaxf(sigma, 0.0f);
}

}  // namespace fnt
