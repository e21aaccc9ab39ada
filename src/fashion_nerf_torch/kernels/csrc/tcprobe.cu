// Tensor-core probe (P1 and P2): chains of square bf16 matrix products with
// f32 accumulation over row slabs.
//
// Replaces: scripts/mfu_probe.py::main (run_variant.go, P1) and
// scripts/mfu_probe.py::shape_sweep (bench.go, P2), the TPU probes that run
// the field's bare topology (9 chained 256x256 products; a width x depth
// sweep) on 2048-row tiles to attribute the fused field's MXU rate.
//
// What bounds it on the H100: bf16 tensor-core throughput. A 64-row slab
// does 2·64·W² FLOP per layer against 2·W² bytes of weights read from L2
// (64 FLOP per byte) and nothing else off chip until its output; in this
// first version the latency of wmma fragment loads from L2, not the
// tensor cores, is the likelier limit.
//
// Design: one CUDA block per 64-row slab (8 warps). The slab's input and
// its activations stay in shared memory as bf16 (one buffer for the
// independent sum, two ping-pong buffers for a chain, three for two
// streams); each warp owns 16-column strips of a layer's output and
// accumulates in f32 wmma fragments (16x16x16); the epilogue applies the
// relu, rounds to bf16 and writes the next layer's operand, or stores the
// f32 result to device memory. Modes, as the reference's bodies compute:
//   0 chain:       h <- bf16(act(h·W_k)) for k < depth; out = h·W_0 (f32)
//   1 streams:     two relu chains over W_0, W_2, ... and W_1, W_3, ...;
//                  out = h1·W_0 + h2·W_1 (f32)
//   2 dependent:   h <- bf16(h·W_k) for k < depth; out = f32(h)
//   3 independent: out = Σ_k x·W_k (f32)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace tcp {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kRows = 64;        // rows per CUDA block (one slab)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;          // bf16 row padding of the smem buffers
constexpr int kMaxTerms = 16;    // products summed into one output

enum Mode { kChain = 0, kStreams = 1, kDependent = 2, kIndependent = 3 };

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Args {
  const bf16* x;    // (n, W)
  const bf16* ws;   // (depth, W, W), row-major K x N
  float* out;       // (n, W)
  int width, depth, relu, mode;
};

__host__ __device__ inline int n_buffers(int mode) {
  return mode == kIndependent ? 1 : (mode == kStreams ? 3 : 2);
}

inline size_t smem_bytes(int mode, int width) {
  return (size_t)n_buffers(mode) * kRows * (width + kPad) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float);
}

// Σ_p A_p·B_p over the slab's kRows rows and W columns (K = W), then
// epi(m, ct, acc) on each 16x16 accumulator tile (row tile m, column strip
// ct). A_p bf16 in shared memory (row stride lda), B_p bf16 row-major in
// device memory.
template <class Epi>
__device__ void slab_mma(const bf16* const* A, const bf16* const* B, int n,
                         int lda, int W, Epi epi) {
  const int warp = threadIdx.x >> 5;
  for (int ct = warp; ct * 16 < W; ct += kWarps) {
    Acc acc[kRows / 16];
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) wmma::fill_fragment(acc[m], 0.0f);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
    for (int p = 0; p < n; ++p) {
      for (int k = 0; k < W; k += 16) {
        wmma::load_matrix_sync(fb, B[p] + (size_t)k * W + ct * 16, W);
#pragma unroll
        for (int m = 0; m < kRows / 16; ++m) {
          wmma::load_matrix_sync(fa, A[p] + m * 16 * lda + k, lda);
          wmma::mma_sync(acc[m], fa, fb, acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kRows / 16; ++m) epi(m, ct, acc[m]);
  }
}

__global__ void __launch_bounds__(kThreads) tc_probe_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int W = a.width, ld = W + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* buf[3];
  for (int i = 0; i < 3; ++i)
    buf[i] = reinterpret_cast<bf16*>(smem_raw) + (size_t)i * kRows * ld;
  float* scratch = reinterpret_cast<float*>(
      smem_raw + (size_t)n_buffers(a.mode) * kRows * ld * sizeof(bf16)) +
      warp * 256;
  const long row0 = (long)blockIdx.x * kRows;
  const size_t WW = (size_t)W * W;

  // the slab's input rows, 16 bytes per thread and load
  const int v8 = W / 8;
  for (int i = threadIdx.x; i < kRows * v8; i += kThreads) {
    const int r = i / v8, c = (i % v8) * 8;
    *reinterpret_cast<uint4*>(buf[0] + r * ld + c) =
        *reinterpret_cast<const uint4*>(a.x + (row0 + r) * W + c);
  }
  __syncthreads();

  // one layer: dst = bf16(act(src·W_k)), through the warp's scratch tile
  auto layer = [&](const bf16* src, int k, bf16* dst, int relu) {
    const bf16* A[1] = {src};
    const bf16* B[1] = {a.ws + k * WW};
    slab_mma(A, B, 1, ld, W, [&](int m, int ct, Acc& f) {
      wmma::store_matrix_sync(scratch, f, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const float v = relu ? fmaxf(scratch[e], 0.0f) : scratch[e];
        dst[(m * 16 + (e >> 4)) * ld + ct * 16 + (e & 15)] =
            __float2bfloat16_rn(v);
      }
      __syncwarp();
    });
    __syncthreads();
  };
  // out = Σ A_p·B_p in f32, stored straight from the fragments
  auto to_out = [&](const bf16* const* A, const bf16* const* B, int n) {
    slab_mma(A, B, n, ld, W, [&](int m, int ct, Acc& f) {
      wmma::store_matrix_sync(a.out + (row0 + m * 16) * W + ct * 16, f, W,
                              wmma::mem_row_major);
    });
  };

  if (a.mode == kChain || a.mode == kDependent) {
    int cur = 0;
    for (int k = 0; k < a.depth; ++k) {
      layer(buf[cur], k, buf[cur ^ 1], a.mode == kChain && a.relu);
      cur ^= 1;
    }
    if (a.mode == kChain) {
      const bf16* A[1] = {buf[cur]};
      const bf16* B[1] = {a.ws};
      to_out(A, B, 1);
    } else {
      for (int i = threadIdx.x; i < kRows * W; i += kThreads) {
        const int r = i / W, c = i % W;
        a.out[(row0 + r) * W + c] = __bfloat162float(buf[cur][r * ld + c]);
      }
    }
  } else if (a.mode == kStreams) {
    // stream 1 over W_0, W_2, ...: buf0 (x) -> buf1 -> buf2 -> buf1 ...
    int h1 = 0;
    for (int k = 0; k + 1 < a.depth; k += 2) {
      const int dst = h1 == 1 ? 2 : 1;
      layer(buf[h1], k, buf[dst], 1);
      h1 = dst;
    }
    // stream 2 over W_1, W_3, ...: x in buf0, ping-pong with the free one
    const int other = h1 == 1 ? 2 : 1;
    int h2 = 0;
    for (int k = 1; k < a.depth; k += 2) {
      const int dst = h2 == 0 ? other : 0;
      layer(buf[h2], k, buf[dst], 1);
      h2 = dst;
    }
    const bf16* A[2] = {buf[h1], buf[h2]};
    const bf16* B[2] = {a.ws, a.ws + WW};
    to_out(A, B, 2);
  } else {
    const bf16* A[kMaxTerms];
    const bf16* B[kMaxTerms];
    for (int k = 0; k < a.depth; ++k) {
      A[k] = buf[0];
      B[k] = a.ws + k * WW;
    }
    to_out(A, B, a.depth);
  }
}

}  // namespace tcp

extern "C" {

// n must be a multiple of 64 and width of 16 (at most 1024); streams takes
// depth >= 2 (even layers feed stream 1, odd ones stream 2), independent at
// most 16 layers. Returns a cudaError_t.
int fnt_tc_probe(const void* x, const void* ws, void* out, int n, int width,
                 int depth, int relu, int mode, void* stream) {
  using namespace tcp;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.ws = static_cast<const bf16*>(ws);
  a.out = static_cast<float*>(out);
  a.width = width;
  a.depth = depth;
  a.relu = relu;
  a.mode = mode;
  if (n % kRows || width < 16 || width > 1024 || width % 16 || depth < 1 ||
      mode < kChain || mode > kIndependent ||
      (mode == kStreams && depth < 2) ||
      (mode == kIndependent && depth > kMaxTerms))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(mode, width);
  cudaError_t err = cudaFuncSetAttribute(
      tc_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  tc_probe_kernel<<<n / kRows, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
