// Fused posenc + NeRF-MLP field, forward (kernel K3).
//
// Replaces: src/fashion_nerf/kernels/posenc_mlp_pallas.py::_field_kernel
// (via _fused_eval / make_fused_field), the TPU kernel that evaluates the
// whole field on 2048-row tiles with activations resident in VMEM.
//
// What bounds it on the H100: bf16 matrix products. A row costs ~0.59M MACs
// of the 8x256 field against 12 bytes of row input/output and a per-ray
// 256-byte view term, so it is far above the bf16 ridge (~295 FLOP/byte);
// the limit is tensor-core throughput, and in this first version the
// latency of wmma fragment loads from L2.
//
// Design: one CUDA block per 64-row slab (8 warps; sizeof(Smem) is 86,272
// bytes by construction, so two blocks fit on an SM). The posenc operand [x | sin | cos],
// built in f32 and rounded to bf16, and every layer's activations stay in
// shared memory; each warp owns 16-column strips of each layer's output and
// accumulates in f32 wmma fragments. The per-ray view term γ(d)·W_dir is
// computed outside (a (R,27)x(27,128) product) and expanded per sample in
// the epilogue. The reference's tile-skip flag is not used by this path.
#include "fnt_common.cuh"

namespace fnt {

struct FieldArgs {
  const float* pts;      // (n, 3)
  const bf16* dirpart;   // (n / spr, width / 2), read only with a view branch
  const bf16* w;         // packed weights (Layout)
  const float* b;        // packed biases (Layout)
  float* rgb;            // (n, 3) post-sigmoid
  float* sigma;          // (n,) raw
  int spr;               // samples per ray: row r takes dirpart[r / spr]
  int L;                 // posenc frequencies
  Layout lay;
};

__global__ void __launch_bounds__(kThreads) field_kernel(FieldArgs a) {
  Smem& s = smem();
  const Layout& lay = a.lay;
  const long row0 = (long)blockIdx.x * kRows;
  // posenc operand: [x (3) | sin(2^f x) blocks | cos blocks | 0-pad]; the
  // reference repeats x 2L times, scales block j by 2^(j mod L) and adds
  // π/2 on the cos half, so one sin pass covers both halves
  const int n_ph = 6 * a.L;
  for (int i = threadIdx.x; i < kRows * lay.k0; i += kThreads) {
    const int r = i / lay.k0, c = i % lay.k0;
    float v = 0.0f;
    if (c < 3) {
      v = a.pts[(row0 + r) * 3 + c];
    } else if (c < 3 + n_ph) {
      const int j = (c - 3) / 3, k = (c - 3) % 3;
      const float f = (float)(1 << (j % a.L));
      const float off = j >= a.L ? kHalfPi : 0.0f;
      v = sinf(__fadd_rn(__fmul_rn(a.pts[(row0 + r) * 3 + k], f), off));
    }
    s.a0[r * kLdA + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int cur = run_trunk(lay, a.w, a.b,
                            [](int, int, int) { return 0.0f; });
  const int half = lay.width / 2;
  run_heads(lay, a.w, a.b, cur, [&](int r, int c) {
    return bf(a.dirpart[((row0 + r) / a.spr) * half + c]);
  });

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    a.sigma[row0 + r] = s.row_sigma[r];
    for (int j = 0; j < 3; ++j) a.rgb[(row0 + r) * 3 + j] = s.row_rgb[r][j];
  }
}

}  // namespace fnt

extern "C" {

// n must be a multiple of 64 (make_fused_field pads). Returns a cudaError_t.
int fnt_field_forward(const void* pts, const void* dirpart, const void* w,
                      const void* b, void* rgb, void* sigma, int n, int spr,
                      int L, int depth, int width, int k0, int skip,
                      int has_vd, void* stream) {
  using namespace fnt;
  FieldArgs a;
  a.pts = static_cast<const float*>(pts);
  a.dirpart = static_cast<const bf16*>(dirpart);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const float*>(b);
  a.rgb = static_cast<float*>(rgb);
  a.sigma = static_cast<float*>(sigma);
  a.spr = spr;
  a.L = L;
  a.lay = make_layout(depth, width, k0, skip, has_vd);
  if (layout_error(a.lay) || n % kRows || spr < 1 || 3 + 6 * L > k0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(field_kernel);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  field_kernel<<<n / kRows, kThreads, sizeof(Smem),
                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* fnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
