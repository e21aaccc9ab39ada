// Tensor-core probe (P1 and P2): chains of square bf16 matrix products with
// f32 accumulation, on the wgmma layer loop of the field kernels.
//
// Replaces: scripts/mfu_probe.py::main (run_variant.go, P1) and
// scripts/mfu_probe.py::shape_sweep (bench.go, P2), the TPU probes that run
// the field's bare topology (9 chained 256x256 products; a width x depth
// sweep) on 2048-row tiles to attribute the fused field's MXU rate.
//
// What bounds it on the H100: bf16 tensor-core throughput (2·W² FLOP a row
// and layer against 2·W bytes of input and 4·W of output a row), then the
// L2 → shared-memory stream of the weights: every CUDA block fetches each
// 64 × 256 slice once per work item of 128 (or 64) rows, 256 (128) FLOP per
// weight byte, and the per-layer epilogue (relu, bf16, store), which runs
// serially with the wgmmas inside a warpgroup. It is the loop of
// wg_field.cuh without sines, biases and heads, so its rate is the ceiling
// of that loop (K2, K3, K4, K6).
//
// Design (the pieces of csrc/wg_trunk.cuh and the ring of csrc/wg_field.cuh):
// - Persistent CUDA blocks, one per SM: one or two consumer warpgroups of 64
//   rows each and one producer warpgroup, whose one lane streams the packed
//   64 × 256 weight slices (probe.py packs them, K-major core-matrix layout)
//   through a ring of 5 slots, or 3 where 5 do not fit, with cp.async.bulk
//   behind full/empty mbarriers; setmaxnreg hands the producer's registers
//   to the consumers. Both warpgroups take every slice, so the ring's depth
//   is how far they can drift apart: with 5 slots a whole 256-wide layer,
//   and one's epilogue can run under the other's wgmmas.
// - A layer of width W = 256·P is P column passes of wgmma m64n256k16 over
//   the same activation tile (A and B in shared memory, the 64 × 256 f32
//   accumulator in registers). The epilogue runs in registers: relu, the
//   bf16 cast, and a store in the core-matrix layout, in place over the
//   warpgroup's own tile at P = 1 and into a second tile at P > 1 (a pass
//   may not overwrite what the next pass reads). f32 results go straight
//   from the accumulators to device memory.
// - Shared memory a block: the ring (160 or 96 KB) and n_wg × n_bufs tiles
//   of 64 × W bf16. probe_plan() picks, in this order, two consumer
//   warpgroups or one and 5 slots or 3, whatever fits in 227 KB first, and
//   refuses the rest (a chain wider than 512, two streams wider than 256):
//   probe.py composes those from this kernel's single-layer launches.
// Modes, as the reference's bodies compute:
//   0 chain:       h <- bf16(act(h·W_k)) for k < depth; out = h·W_0 (f32)
//   1 streams:     two relu chains over W_0, W_2, ... and W_1, W_3, ...,
//                  one after the other; out = h1·W_0 + h2·W_1 (f32, one
//                  accumulator)
//   2 dependent:   h <- bf16(h·W_k) for k < depth; out = f32(h)
//   3 independent: out = Σ_k x·W_k (f32)
#include "wg_field.cuh"

namespace fnt {
namespace {

constexpr int kDeepP = 5, kShallowP = 3;          // slots of the ring
constexpr int kColsP = 256;                       // columns of a pass
constexpr int kSliceBytesP = wg::kSliceK * kColsP * 2;
constexpr int kMaxSmemP = 227 * 1024;

// acc (+)= A·B, A the thread's fragment of a 64 × 16 bf16 tile in four
// registers (rows rA and rA + 8, columns cA, cA + 1 and cA + 8, cA + 9, as
// pairs), B from shared memory: the accumulator's own layout, so a layer's
// output can feed the next layer's products without leaving the registers.
__device__ __forceinline__ void mma_rs_n256(float (&d)[128], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

enum Mode { kChain = 0, kStreams = 1, kDependent = 2, kIndependent = 3 };

template <int S>
struct __align__(128) ProbeSmem {
  wgf::Ring<S> ring;
  // the activation tiles follow: n_wg × n_bufs × (64 × W) bf16
};

struct ProbeArgs {
  const bf16* x;    // (n, W) row-major
  const bf16* wp;   // (depth, P, W/64) slices of 64 × 256, each tiled
  float* out;       // (n, W) row-major
  int n, W, depth, relu, mode, n_wg, n_bufs, slots;
};

// Consumer warpgroups, tiles per warpgroup and ring slots for (mode, W,
// depth); false where the tiles do not fit beside the ring. A one-layer
// dependent chain writes no tile: its only layer goes to device memory.
inline bool probe_plan(int mode, int W, int depth, int* n_wg, int* n_bufs,
                       int* slots) {
  const int P = W / kColsP;
  if (mode == kStreams && P != 1) return false;
  const bool reads_only =
      mode == kIndependent || (mode == kDependent && depth == 1);
  *n_bufs = reads_only ? 1 : (mode == kStreams || P > 1) ? 2 : 1;
  const int tile = wg::kWgRows * W * 2;
  const int rings[2][2] = {{kDeepP, (int)sizeof(ProbeSmem<kDeepP>)},
                           {kShallowP, (int)sizeof(ProbeSmem<kShallowP>)}};
  for (*n_wg = 2; *n_wg >= 1; --*n_wg)
    for (const auto& ring : rings) {
      *slots = ring[0];
      if (ring[1] + *n_wg * *n_bufs * tile <= kMaxSmemP) return true;
    }
  return false;
}

// The producer lane: per work item, every slice in the order the consumers
// take them.
template <int S>
__device__ __forceinline__ void produce_probe(wgf::Ring<S>& r,
                                              const ProbeArgs& a,
                                              int n_items) {
  const int P = a.W / kColsP, KS = a.W / wg::kSliceK, D = a.depth;
  int stage = 0;
  uint32_t phase = 0;
  auto emit = [&](int layer, int cp) {
    const char* src = reinterpret_cast<const char*>(a.wp) +
                      (size_t)((layer * P + cp) * KS) * kSliceBytesP;
    for (int ks = 0; ks < KS; ++ks) {
      wg::mbar_wait(&r.empty[stage], phase ^ 1u);
      wg::mbar_expect_tx(&r.full[stage], kSliceBytesP);
      wg::bulk_load(r.slot[stage], src + (size_t)ks * kSliceBytesP,
                    kSliceBytesP, &r.full[stage]);
      if (++stage == S) {
        stage = 0;
        phase ^= 1u;
      }
    }
  };
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    if (a.mode == kIndependent) {
      for (int cp = 0; cp < P; ++cp)
        for (int k = 0; k < D; ++k) emit(k, cp);
    } else if (a.mode == kStreams) {
      for (int k = 0; k + 1 < D; k += 2) emit(k, 0);
      for (int k = 1; k < D; k += 2) emit(k, 0);
      emit(0, 0);
      emit(1, 0);
    } else {
      for (int k = 0; k < D; ++k)
        for (int cp = 0; cp < P; ++cp) emit(k, cp);
      if (a.mode == kChain)
        for (int cp = 0; cp < P; ++cp) emit(0, cp);
    }
  }
}

// kHold (the chain at W = 256 only): from the second layer on the
// activations never leave the registers. The epilogue packs relu'd bf16
// pairs of the accumulator into 64 registers, which are the next layer's A
// fragments, and the layer's wgmmas read A from them: no shared-memory
// store, no async-proxy fence and no warpgroup barrier between layers.
template <int S, bool kHold>
__global__ void __launch_bounds__(wgf::kThreads, 1)
    tc_probe_kernel(const __grid_constant__ ProbeArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ProbeSmem<S>& s = *reinterpret_cast<ProbeSmem<S>*>(smem_raw);
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw + sizeof(ProbeSmem<S>));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = a.W, P = W / kColsP, KS = W / wg::kSliceK, D = a.depth;
  const int cons_warps = 4 * a.n_wg;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      wg::mbar_init(&s.ring.full[i], 1);
      wg::mbar_init(&s.ring.empty[i], cons_warps);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  const int item_rows = wg::kWgRows * a.n_wg;
  const int n_items = (a.n + item_rows - 1) / item_rows;

  if (warp >= cons_warps) {
    wg::setmaxnreg_dec<40>();
    if (warp == cons_warps && lane == 0) produce_probe(s.ring, a, n_items);
    return;
  }

  // consumers: warpgroup g owns rows [64g, 64g + 64) of each item; a last
  // item without rows for it runs on, touching no device memory
  wg::setmaxnreg_inc<232>();
  const int g = threadIdx.x >> 7, tw = threadIdx.x & 127, ww = tw >> 5;
  const int bar = 1 + g;
  const int rA = 16 * ww + (lane >> 2), cA = 2 * (lane & 3);
  bf16* buf0 = tiles + (size_t)g * a.n_bufs * wg::kWgRows * W;
  bf16* buf1 = buf0 + (a.n_bufs > 1 ? wg::kWgRows * W : 0);
  wgf::RingPos rp{0, 0u, -1};
  float acc[kColsP / 2];
  uint32_t held[kHold ? kColsP / 4 : 1] = {};   // a layer's output as A
                                                // fragments

  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const long row0 = (long)it * item_rows + wg::kWgRows * g;
    const bool live = row0 < a.n;

    // the tile's input rows into the core-matrix layout, 16 bytes a thread:
    // a warp takes 8 rows × 4 chunks (64 contiguous bytes a row in device
    // memory, 512 contiguous bytes in shared memory)
    auto load_x = [&](bf16* dst) {
      const int cgs = W / 32;   // groups of 4 chunks of 8 columns
      for (int i = tw; i < wg::kWgRows * (W / 8); i += 128) {
        const int grp = i >> 5, l = i & 31;
        const int r = (grp / cgs) * 8 + (l & 7);
        const int c = ((grp % cgs) * 4 + (l >> 3)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (live)
          v = *reinterpret_cast<const uint4*>(a.x + (row0 + r) * W + c);
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst) +
                                  wg::cm_off(r, c, W)) = v;
      }
    };
    load_x(buf0);
    if (a.mode == kStreams) load_x(buf1);
    wg::fence_async_smem();
    wg::wg_sync(bar);

    // The item as a sequence of column blocks, each one accumulator: which
    // tiles it multiplies, over how many layers' slices, and where its
    // epilogue puts it. One loop body for every mode, so that the
    // accumulator stays in registers.
    const int half = D / 2;   // layers of each of the two streams
    const int n_steps = a.mode == kIndependent ? P
                        : a.mode == kStreams   ? 2 * half + 1
                        : (D + (a.mode == kChain ? 1 : 0)) * P;
    for (int step = 0; step < n_steps; ++step) {
      const bf16* src = buf0;
      const bf16* src2 = nullptr;   // second term of the streams' sum
      bf16* dst = buf0;
      int cp = 0, terms = 1;
      int kind = 0;   // 0 bf16 tile, 1 the same values as f32 out, 2 f32 out
      if (a.mode == kIndependent) {
        cp = step;
        terms = D;
        kind = 2;
      } else if (a.mode == kStreams) {
        if (step == 2 * half) {
          src2 = buf1;
          kind = 2;
        } else if (step >= half) {
          src = dst = buf1;
        }
      } else {
        const int k = step / P;
        cp = step % P;
        src = (P > 1 && (k & 1)) ? buf1 : buf0;
        dst = (P > 1 && !(k & 1)) ? buf1 : buf0;
        kind = k == D ? 2 : (a.mode == kDependent && k == D - 1) ? 1 : 0;
      }
      const bool relu = a.mode == kStreams || (a.mode == kChain && a.relu);
      const int n_slices = (src2 != nullptr ? 2 : terms) * KS;
      const uint32_t addr1 = wg::smem_addr(src);
      const uint32_t addr2 = src2 != nullptr ? wg::smem_addr(src2) : addr1;
      if (kHold && step > 0) {
        // as wgf::consume, A from the held registers
        if constexpr (kHold) {
#pragma unroll
          for (int ks = 0; ks < kColsP / wg::kSliceK; ++ks) {
            wg::mbar_wait(&s.ring.full[rp.stage], rp.phase);
            wg::mma_fence();
            const uint32_t b_addr = wg::smem_addr(s.ring.slot[rp.stage]);
#pragma unroll
            for (int kb = 0; kb < wg::kSliceK / 16; ++kb) {
              const int m = 4 * (4 * ks + kb);
              mma_rs_n256(acc, held[m], held[m + 1], held[m + 2], held[m + 3],
                          wg::desc(b_addr + wg::cm_off(0, 16 * kb, wg::kSliceK),
                                   wg::kSliceK * 16),
                          (ks | kb) ? 1 : 0);
            }
            wg::mma_commit();
            if (rp.pend >= 0) {
              wg::mma_wait<1>();
              wgf::release(s.ring, rp.pend);
            }
            rp.pend = rp.stage;
            if (++rp.stage == S) {
              rp.stage = 0;
              rp.phase ^= 1u;
            }
          }
        }
      } else {
        for (int sl = 0; sl < n_slices; ++sl) {
          const int ks = sl % KS;
          wgf::consume<kColsP>(acc, rp, s.ring,
                               (src2 != nullptr && sl >= KS) ? addr2 : addr1,
                               W, ks * wg::kSliceK, wg::kSliceK, sl == 0);
        }
      }
      wgf::drain(acc, rp, s.ring);
      if constexpr (kHold) {
        // the wgmmas read the registers until the wait: keep them live
#pragma unroll
        for (int m = 0; m < kColsP / 4; ++m)
          asm volatile("" : "+r"(held[m])::"memory");
        if (kind == 0) {
#pragma unroll
          for (int m = 0; m < kColsP / 4; ++m) {
            float v0 = acc[2 * m], v1 = acc[2 * m + 1];
            if (relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            const __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
            held[m] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          continue;
        }
      }
      if (kind == 0 && dst == src) wg::wg_sync(bar);   // all done reading it
      float* o_lo = a.out + (row0 + rA) * W + cp * kColsP + cA;
      float* o_hi = o_lo + 8 * (long)W;
#pragma unroll
      for (int j = 0; j < kColsP / 8; ++j) {
        float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                      acc[4 * j + 3]};
        if (kind == 2) {
          if (live) {
            *reinterpret_cast<float2*>(o_lo + 8 * j) =
                make_float2(v[0], v[1]);
            *reinterpret_cast<float2*>(o_hi + 8 * j) =
                make_float2(v[2], v[3]);
          }
          continue;
        }
        if (relu) {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = fmaxf(v[q], 0.0f);
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        if (kind == 1) {
          if (live) {
            *reinterpret_cast<float2*>(o_lo + 8 * j) = __bfloat1622float2(lo);
            *reinterpret_cast<float2*>(o_hi + 8 * j) = __bfloat1622float2(hi);
          }
        } else {
          const int c = cp * kColsP + 8 * j + cA;
          wgf::st_pair(dst, rA, c, W, lo);
          wgf::st_pair(dst, rA + 8, c, W, hi);
        }
      }
      if (kind == 0 && cp == P - 1) {   // the layer's tile is complete
        wg::fence_async_smem();
        wg::wg_sync(bar);
      }
    }
    wg::wg_sync(bar);   // the tiles are free for the next item's rows
  }
}

template <int S, bool kHold>
int launch_probe(const ProbeArgs& a, int device, cudaStream_t st) {
  const int smem = (int)sizeof(ProbeSmem<S>) +
                   a.n_wg * a.n_bufs * wg::kWgRows * a.W * 2;
  cudaError_t err =
      set_smem((const void*)tc_probe_kernel<S, kHold>, device, smem);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0;
  err = sm_count(device, &n_sm);
  if (err != cudaSuccess) return (int)err;
  if (a.n == 0) return 0;
  const int item_rows = wg::kWgRows * a.n_wg;
  const int n_items = (a.n + item_rows - 1) / item_rows;
  tc_probe_kernel<S, kHold><<<n_items < n_sm ? n_items : n_sm,
                              128 * (a.n_wg + 1), smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fnt

extern "C" {

// x (n, W) bf16, wp the packed slices of (depth, W, W) weights, out (n, W)
// f32. n must be a multiple of 64 and W of 256, at most 1024; streams takes
// depth >= 2 (even layers feed stream 1, odd ones stream 2); hold (the
// activations held in registers) takes the chain at W = 256. Shapes whose
// tiles do not fit in shared memory (probe_plan) are refused. device: the
// operands' CUDA device. Returns a cudaError_t.
int fnt_tc_probe(const void* x, const void* wp, void* out, int n, int width,
                 int depth, int relu, int mode, int hold, int device,
                 void* stream) {
  using namespace fnt;
  DeviceGuard on(device);
  if (on.error()) return on.error();
  ProbeArgs a;
  a.x = static_cast<const bf16*>(x);
  a.wp = static_cast<const bf16*>(wp);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.W = width;
  a.depth = depth;
  a.relu = relu;
  a.mode = mode;
  if (n < 0 || n % wg::kWgRows || width < kColsP || width > 1024 ||
      width % kColsP || depth < 1 || mode < kChain || mode > kIndependent ||
      (mode == kStreams && depth < 2) ||
      (hold && (mode != kChain || width != kColsP)) ||
      (reinterpret_cast<uintptr_t>(wp) & 15) ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      !probe_plan(mode, width, depth, &a.n_wg, &a.n_bufs, &a.slots))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hold) {
    if (a.slots != kDeepP || a.n_wg != 2) return (int)cudaErrorInvalidValue;
    return launch_probe<kDeepP, true>(a, device, st);
  }
  if (a.slots == kDeepP) return launch_probe<kDeepP, false>(a, device, st);
  return launch_probe<kShallowP, false>(a, device, st);
}

}  // extern "C"
