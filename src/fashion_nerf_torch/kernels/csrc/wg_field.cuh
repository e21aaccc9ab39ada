// Shared device code of the kernels on the streamed wgmma layer loop
// (field.cu K3, field_bwd.cu K4, carrymarch.cu K6, and the ring for
// tcprobe.cu): the weight ring, the posenc operand of positions, the
// forward of the packed field on one warpgroup's 64 rows, and the bulk
// stores that copy K4's activation tiles to its workspace.
//
// Block shape (as slimmarch.cu): two consumer warpgroups and one producer
// warpgroup; a work item is 128 rows, 64 per consumer warpgroup. The
// producer's one lane streams the net's slices (kernels/wgpack.py,
// `field_buffer`) through a ring of S slots of 64 × 256 bf16 with
// cp.async.bulk behind full/empty mbarriers; both warpgroups take every
// slice. Widths 128 and 256 (template W), depth ≤ kMaxFieldDepth, posenc
// operand k0 in {48, 64}.
#pragma once

#include "fnt_common.cuh"
#include "wg_trunk.cuh"

namespace fnt {
namespace wgf {

constexpr int kConsumers = 2 * 128;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;     // and the producer
constexpr int kMaxW = 256;
constexpr int kMaxFieldDepth = 8;
constexpr int kMaxSlices = 160;
constexpr int kMaxRays = 8;    // rays of a warpgroup staged in shared memory

template <int S>
struct __align__(128) Ring {
  bf16 slot[S][wg::kSliceK * kMaxW];
  uint64_t full[S];
  uint64_t empty[S];
};

// The consumers' position in the ring: the slot to wait for next, and the
// slot whose wgmmas may still run (released after the next one's issue).
struct RingPos {
  int stage;
  uint32_t phase;
  int pend;
};

template <int S>
__device__ __forceinline__ void ring_init(Ring<S>& r) {
  for (int i = 0; i < S; ++i) {
    wg::mbar_init(&r.full[i], 1);
    wg::mbar_init(&r.empty[i], kConsumers / 32);
  }
  wg::mbar_init_fence();
}

template <int S>
__device__ __forceinline__ void release(Ring<S>& r, int stage) {
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(&r.empty[stage]);
}

// acc (+)= A·(the next slice, kk rows of K × N), A at column a_k of the
// tile at a_addr (a_K columns). Keeps one slice's wgmmas in flight.
template <int N, int S>
__device__ __forceinline__ void consume(float (&acc)[N / 2], RingPos& rp,
                                        Ring<S>& r, uint32_t a_addr, int a_K,
                                        int a_k, int kk, bool zero) {
  wg::mbar_wait(&r.full[rp.stage], rp.phase);
  wg::mma_fence();
  wg::mma_slice<N>(acc, a_addr, a_K, a_k, wg::smem_addr(r.slot[rp.stage]), kk,
                   zero);
  wg::mma_commit();
  if (rp.pend >= 0) {
    wg::mma_wait<1>();
    release(r, rp.pend);
  }
  rp.pend = rp.stage;
  if (++rp.stage == S) {
    rp.stage = 0;
    rp.phase ^= 1u;
  }
}

template <int S, int R>
__device__ __forceinline__ void drain(float (&acc)[R], RingPos& rp,
                                      Ring<S>& r) {
  wg::mma_wait<0>();
  wg::fence_regs(acc);
  release(r, rp.pend);
  rp.pend = -1;
}

// Whether work item `it` lies in a live predication tile (K3's tile-skip
// flag): alive null means every tile is; a tile of tile_rows rows holds
// whole items (tile_rows a multiple of kItemRows, or the whole launch).
__device__ __forceinline__ bool item_live(const float* alive, int it,
                                          int tile_rows) {
  return alive == nullptr ||
         alive[(long)it * wg::kItemRows / tile_rows] > 0.0f;
}

// The producer lane: every live item takes all n_slices slices of src in
// order; an item of a dead tile (item_live) takes none. reps: the items of
// each of the block's n_items work units (wg::unit_items).
template <int S>
__device__ __forceinline__ void produce(Ring<S>& r, const bf16* src0,
                                        const int* slice_bytes, int n_slices,
                                        int n_items,
                                        const float* alive = nullptr,
                                        int tile_rows = 0, int reps = 1) {
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x)
  for (int rep = 0; rep < reps; ++rep) {
    if (!item_live(alive, it, tile_rows)) continue;
    const char* src = reinterpret_cast<const char*>(src0);
    for (int sl = 0; sl < n_slices; ++sl) {
      const int bytes = slice_bytes[sl];
      wg::mbar_wait(&r.empty[stage], phase ^ 1u);
      wg::mbar_expect_tx(&r.full[stage], bytes);
      wg::bulk_load(r.slot[stage], src, bytes, &r.full[stage]);
      src += bytes;
      if (++stage == S) {
        stage = 0;
        phase ^= 1u;
      }
    }
  }
}

// Slice list of the field buffer (kernels/wgpack.py::field_slices, then
// field_slices_t when `transposed`): the bytes of each slice in order.
// Returns the count, or -1 if it exceeds kMaxSlices.
inline int field_slice_bytes(const Layout& lay, bool transposed,
                             int* bytes) {
  const int W = lay.width, half = W / 2, k0 = lay.k0;
  int n = 0;
  auto add = [&](int rows, int cols) {
    for (int k = 0; k < rows; k += wg::kSliceK) {
      if (n >= kMaxSlices) { n = kMaxSlices + 1; return; }
      bytes[n++] = (rows - k < wg::kSliceK ? rows - k : wg::kSliceK) * cols * 2;
    }
  };
  for (int i = 0; i < lay.depth; ++i) {
    if (lay.w_h[i] >= 0) add(W, W);
    if (lay.w_a0[i] >= 0) add(k0, W);
  }
  if (lay.has_vd) { add(W, W); add(W, half); }
  if (transposed) {
    if (lay.has_vd) { add(half, W); add(W, W); }
    for (int i = lay.depth - 1; i >= 0; --i) {
      if (lay.w_a0[i] >= 0) add(W, k0);
      if (lay.w_h[i] >= 0) add(W, W);
    }
  }
  return n > kMaxSlices ? -1 : n;
}

// Layers that take the posenc operand, and so the cond window of a
// conditioned net: trunk_0 and every skip layer.
inline int cond_layers(const Layout& L) {
  int n = 0;
  for (int i = 0; i < L.depth; ++i) n += L.w_a0[i] >= 0;
  return n;
}

// Checks a layout the wgmma field kernels take; 0 if fine.
inline int field_layout_error(const Layout& L) {
  if (layout_error(L) || !(L.width == 128 || L.width == 256)) return 1;
  if (L.depth < 2 || L.depth > kMaxFieldDepth) return 1;
  if (!(L.k0 == 48 || L.k0 == 64)) return 1;
  return 0;
}

__device__ __forceinline__ void st_pair(bf16* tile, int r, int c, int K,
                                        __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<char*>(tile) +
                                     wg::cm_off(r, c, K)) = v;
}

// Posenc operand of the warpgroup's 64 rows into A0 (core-matrix layout,
// k0 columns): [x (3) | sin(x·2^f (+π/2)) blocks | 0-pad]. The reference
// repeats x 2L times, scales block j by 2^(j mod L) and adds π/2 on the cos
// half, so one sin pass covers both halves. pts: the rows' positions.
__device__ __forceinline__ void posenc_tile(bf16* A0, int k0, int L,
                                            const float (*pts)[3], int tw) {
  const int n_ph = 6 * L;
  for (int i = tw; i < 32 * k0; i += 128) {
    const int cm = i >> 5;
    const int r = (cm & 7) * 8 + ((i & 31) >> 2);
    const int c0 = (cm >> 3) * 8 + (i & 3) * 2;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + e;
      v[e] = 0.0f;
      if (c < 3) {
        v[e] = pts[r][c];
      } else if (c < 3 + n_ph) {
        const int j = (c - 3) / 3, k = (c - 3) % 3;
        const float f = (float)(1 << (j % L));
        const float off = j >= L ? kHalfPi : 0.0f;
        v[e] = sinf(__fadd_rn(__fmul_rn(pts[r][k], f), off));
      }
    }
    st_pair(A0, r, c0, k0, __floats2bfloat162_rn(v[0], v[1]));
  }
}

// Asynchronous bulk copy of `bytes` from shared into device memory (a
// multiple of 16, both 16-byte aligned), in the issuing thread's bulk group.
// The lines it writes are the first the L2 evicts (evict_first): K4's
// workspace is written once and read once by the next kernel, and with the
// default policy its stream cost K4's rows kernel about a third of its
// time (PERF.md §5).
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "{\n.reg .b64 policy;\n"
      "createpolicy.fractional.L2::evict_first.b64 policy, 1.0;\n"
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, policy;\n}\n" ::"l"(dst),
      "r"(wg::smem_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of the thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of the thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warpgroup's view of a work item for the forward.
struct Rows {
  bf16* H;                  // activations, 64 × W
  bf16* A0;                 // posenc operand, 64 × k0
  const float* bias;        // the net's biases (shared memory)
  const float* heads;       // σ (W) and rgb (W/2 × 3) heads, or out (W × 4)
  const float (*pts)[3];    // the rows' positions
  const bf16* dir_lo;       // view term of row rA (W/2), smem or global
  const bf16* dir_hi;       // of row rA + 8
  float* row_sigma;         // (64) raw σ
  float (*row_rgb)[3];      // (64) post-sigmoid rgb
  uint32_t* mask;           // K4: relu bits, (depth, W/64, 128) words
  int tw, ww, lane, bar, rA, cA;
  // the cond window (forward<W, true>): the condpart row of row rA's ray
  // and of row rA + 8's, n_cond·W bf16 in device memory, W-wide slice ci
  // feeding the ci-th layer that takes the posenc operand
  const bf16* cond_lo = nullptr;
  const bf16* cond_hi = nullptr;
};

// The forward of the packed field on the warpgroup's rows: trunk, heads.
// Leaves row_sigma and row_rgb; with a view branch H ends as the view
// layer's bf16 output (64 × W/2). K4 passes mask (the relu bits of every
// trunk layer, as the thread's accumulator elements), stored(kind, i),
// called once each tile is final (kind 0 the trunk layer i, 1 the feature
// layer, 2 the view layer), and guard(), called before each epilogue
// overwrites H. kCond adds the cond window: the accumulator of the ci-th
// layer that takes the posenc operand (the first, then each skip layer)
// takes float(condpart slice ci) before the bias, as the reference's
// mlp_rows adds it (acc + c + b); without it the epilogue is unchanged.
// kOneRay: rows rA and rA + 8 lie in one ray (a march of SB ≥ 16), so
// their view term and cond row are read once, through dir_lo and cond_lo.
template <int W, bool kCond = false, bool kOneRay = false, int S,
          class Stored, class Guard>
__device__ __forceinline__ void forward(const Layout& lay, Rows& t,
                                        Ring<S>& ring, RingPos& rp,
                                        float (&acc)[W / 2], Stored stored,
                                        Guard guard) {
  constexpr int kHalf = W / 2;
  const uint32_t h_addr = wg::smem_addr(t.H), a0_addr = wg::smem_addr(t.A0);
  const int k0 = lay.k0, rA = t.rA, cA = t.cA, lane = t.lane;
  float(&acc_v)[kHalf / 2] = *reinterpret_cast<float(*)[kHalf / 2]>(acc);
  int ci = 0;   // cond layers so far
  for (int i = 0; i < lay.depth; ++i) {
    const bool last = i == lay.depth - 1;
    bool zero = true;
    if (lay.w_h[i] >= 0)
      for (int k = 0; k < W; k += wg::kSliceK) {
        consume<W>(acc, rp, ring, h_addr, W, k, wg::kSliceK, zero);
        zero = false;
      }
    if (lay.w_a0[i] >= 0) consume<W>(acc, rp, ring, a0_addr, k0, 0, k0, zero);
    drain(acc, rp, ring);
    guard();
    wg::wg_sync(t.bar);   // the whole warpgroup is done reading H
    const float* bl = t.bias + lay.b[i];
    float hd_lo[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hd_hi[4] = {0.0f, 0.0f, 0.0f,
                                                          0.0f};
    uint32_t bits[W / 64];
#pragma unroll
    for (int w = 0; w < W / 64; ++w) bits[w] = 0u;
    const bool cond_layer = kCond && lay.w_a0[i] >= 0;
    const bf16* c_lo = cond_layer ? t.cond_lo + ci * W : nullptr;
    const bf16* c_hi =
        cond_layer ? (kOneRay ? c_lo : t.cond_hi + ci * W) : nullptr;
    if (cond_layer) ++ci;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = 8 * j + cA;
      const float b0 = bl[c], b1 = bl[c + 1];
      float a4[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                     acc[4 * j + 3]};
      if (kCond && cond_layer) {
        const float2 cl = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(c_lo + c));
        const float2 ch = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(c_hi + c));
        a4[0] = __fadd_rn(a4[0], cl.x);
        a4[1] = __fadd_rn(a4[1], cl.y);
        a4[2] = __fadd_rn(a4[2], ch.x);
        a4[3] = __fadd_rn(a4[3], ch.y);
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          fmaxf(__fadd_rn(a4[0], b0), 0.0f),
          fmaxf(__fadd_rn(a4[1], b1), 0.0f));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          fmaxf(__fadd_rn(a4[2], b0), 0.0f),
          fmaxf(__fadd_rn(a4[3], b1), 0.0f));
      st_pair(t.H, rA, c, W, lo);
      st_pair(t.H, rA + 8, c, W, hi);
      const float v[4] = {__low2float(lo), __high2float(lo), __low2float(hi),
                          __high2float(hi)};
      if (t.mask) {
        uint32_t m = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) m |= (v[q] > 0.0f ? 1u : 0u) << q;
        bits[j / 8] |= m << (4 * (j % 8));
      }
      if (last) {
        if (lay.has_vd) {
          const float s0 = t.heads[c], s1 = t.heads[c + 1];
          hd_lo[3] = fmaf(v[0], s0, fmaf(v[1], s1, hd_lo[3]));
          hd_hi[3] = fmaf(v[2], s0, fmaf(v[3], s1, hd_hi[3]));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float w0 = t.heads[c * 4 + q], w1 = t.heads[(c + 1) * 4 + q];
            hd_lo[q] = fmaf(v[0], w0, fmaf(v[1], w1, hd_lo[q]));
            hd_hi[q] = fmaf(v[2], w0, fmaf(v[3], w1, hd_hi[q]));
          }
        }
      }
    }
    if (t.mask) {
#pragma unroll
      for (int w = 0; w < W / 64; ++w)
        t.mask[(i * (W / 64) + w) * 128 + t.tw] = bits[w];
    }
    if (last) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hd_lo[q] += __shfl_xor_sync(0xffffffffu, hd_lo[q], 1);
        hd_lo[q] += __shfl_xor_sync(0xffffffffu, hd_lo[q], 2);
        hd_hi[q] += __shfl_xor_sync(0xffffffffu, hd_hi[q], 1);
        hd_hi[q] += __shfl_xor_sync(0xffffffffu, hd_hi[q], 2);
      }
      if ((lane & 3) == 0) {
        if (lay.has_vd) {
          t.row_sigma[rA] = hd_lo[3] + t.bias[lay.b_sig];
          t.row_sigma[rA + 8] = hd_hi[3] + t.bias[lay.b_sig];
        } else {
          for (int q = 0; q < 3; ++q) {
            t.row_rgb[rA][q] = sigmoidf(hd_lo[q] + t.bias[lay.b_out + q]);
            t.row_rgb[rA + 8][q] = sigmoidf(hd_hi[q] + t.bias[lay.b_out + q]);
          }
          t.row_sigma[rA] = hd_lo[3] + t.bias[lay.b_out + 3];
          t.row_sigma[rA + 8] = hd_hi[3] + t.bias[lay.b_out + 3];
        }
      }
    }
    wg::fence_async_smem();
    wg::wg_sync(t.bar);
    stored(0, i);
  }
  if (!lay.has_vd) return;

  // feature layer: bf16(h·W_feat + b), no relu, in place
  for (int k = 0; k < W; k += wg::kSliceK)
    consume<W>(acc, rp, ring, h_addr, W, k, wg::kSliceK, k == 0);
  drain(acc, rp, ring);
  guard();
  wg::wg_sync(t.bar);
  {
    const float* bl = t.bias + lay.b_feat;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int c = 8 * j + cA;
      const float b0 = bl[c], b1 = bl[c + 1];
      st_pair(t.H, rA, c, W,
              __floats2bfloat162_rn(__fadd_rn(acc[4 * j], b0),
                                    __fadd_rn(acc[4 * j + 1], b1)));
      st_pair(t.H, rA + 8, c, W,
              __floats2bfloat162_rn(__fadd_rn(acc[4 * j + 2], b0),
                                    __fadd_rn(acc[4 * j + 3], b1)));
    }
  }
  wg::fence_async_smem();
  wg::wg_sync(t.bar);
  stored(1, 0);

  // view layer (N = W/2) with the per-ray view term, then the rgb head; the
  // bf16 view output goes over H as a 64 × W/2 tile
  for (int k = 0; k < W; k += wg::kSliceK)
    consume<kHalf>(acc_v, rp, ring, h_addr, W, k, wg::kSliceK, k == 0);
  drain(acc_v, rp, ring);
  guard();
  wg::wg_sync(t.bar);
  {
    const float* bl = t.bias + lay.b_view;
    const float* wr = t.heads + W;
    float c_lo[3] = {0.0f, 0.0f, 0.0f}, c_hi[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      const int c = 8 * j + cA;
      const float b0 = bl[c], b1 = bl[c + 1];
      const float2 dl = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(t.dir_lo + c));
      const float2 dh = kOneRay ? dl : __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(t.dir_hi + c));
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          fmaxf(__fadd_rn(__fadd_rn(acc_v[4 * j], dl.x), b0), 0.0f),
          fmaxf(__fadd_rn(__fadd_rn(acc_v[4 * j + 1], dl.y), b1), 0.0f));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          fmaxf(__fadd_rn(__fadd_rn(acc_v[4 * j + 2], dh.x), b0), 0.0f),
          fmaxf(__fadd_rn(__fadd_rn(acc_v[4 * j + 3], dh.y), b1), 0.0f));
      st_pair(t.H, rA, c, kHalf, lo);
      st_pair(t.H, rA + 8, c, kHalf, hi);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float w0 = wr[c * 3 + q], w1 = wr[(c + 1) * 3 + q];
        c_lo[q] = fmaf(__low2float(lo), w0, fmaf(__high2float(lo), w1, c_lo[q]));
        c_hi[q] = fmaf(__low2float(hi), w0, fmaf(__high2float(hi), w1, c_hi[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      c_lo[q] += __shfl_xor_sync(0xffffffffu, c_lo[q], 1);
      c_lo[q] += __shfl_xor_sync(0xffffffffu, c_lo[q], 2);
      c_hi[q] += __shfl_xor_sync(0xffffffffu, c_hi[q], 1);
      c_hi[q] += __shfl_xor_sync(0xffffffffu, c_hi[q], 2);
      if ((lane & 3) == 0) {
        t.row_rgb[rA][q] = sigmoidf(c_lo[q] + t.bias[lay.b_rgb + q]);
        t.row_rgb[rA + 8][q] = sigmoidf(c_hi[q] + t.bias[lay.b_rgb + q]);
      }
    }
  }
  wg::fence_async_smem();
  wg::wg_sync(t.bar);
  stored(2, 0);
}

}  // namespace wgf
}  // namespace fnt
