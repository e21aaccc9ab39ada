// Shared device code of the Hopper kernels (sigmamarch.cu, slimmarch.cu,
// and through wg_field.cuh field.cu, field_bwd.cu, carrymarch.cu and
// tcprobe.cu): the warpgroup
// matrix multiply (wgmma) layer loop, its shared-memory
// operand layout, the mbarrier/bulk-copy primitives that bring weights into
// shared memory, and the warp-level compositing scan.
//
// Operand layout. Both wgmma operands live in shared memory, K-major, in
// the no-swizzle "core matrix" layout: a core matrix is 8 rows × 16 bytes
// (8 rows × 8 bf16) stored as 128 contiguous bytes; core matrices that
// neighbour along K are 128 bytes apart (the descriptor's leading byte
// offset) and 8-row groups are K·16 bytes apart (its stride byte offset).
// cm_off() gives the byte offset of element (r, k) of a tile with K
// columns. A: the activation tile of a warpgroup, 64 rows × K. B: a weight
// slice of kk rows of K × N columns, stored N-major as (n, k) with K = kk,
// which kernels/wgpack.py builds once per net. The epilogue writes bf16
// pairs (r, c), (r, c+1) of the accumulator layout: a warp's 32 lanes fill
// one core matrix (8 rows × 4 words), so the stores hit 32 distinct banks.
//
// Accumulator layout of wgmma m64nNk16 (f32): warp w of the warpgroup holds
// rows 16w..16w+15; lane l holds, for i in 0..N/2-1, the element at row
// 16w + l/4 + 8·((i/2)%2), column 8·(i/4) + 2·(l%4) + i%2.
//
// Build for sm_90a: wgmma exists only there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fnt {
namespace wg {

constexpr int kWgRows = 64;       // rows of one consumer warpgroup
constexpr int kItemRows = 128;    // rows of one work item (two warpgroups)
constexpr int kSliceK = 64;       // K rows of a full weight slice

__host__ __device__ __forceinline__ uint32_t cm_off(int r, int k, int K) {
  return (uint32_t)((r >> 3) * K * 16 + (k >> 3) * 128 + (r & 7) * 16 +
                    (k & 7) * 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset 128 (the next core matrix along K), stride byte offset sbo
// (the next 8-row group).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da,
                                        uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da,
                                        uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// The narrower shapes of the field kernels: the view layer at width 128
// and the posenc operand's dgrad (N = k0).
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_n48(float (&d)[24], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db, int acc);
template <>
__device__ __forceinline__ void mma<256>(float (&d)[128], uint64_t da,
                                         uint64_t db, int acc) {
  mma_n256(d, da, db, acc);
}
template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  mma_n128(d, da, db, acc);
}

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], uint64_t da,
                                        uint64_t db, int acc) {
  mma_n64(d, da, db, acc);
}
template <>
__device__ __forceinline__ void mma<48>(float (&d)[24], uint64_t da,
                                        uint64_t db, int acc) {
  mma_n48(d, da, db, acc);
}

// acc += A·B with both operands MN-major in shared memory (the transpose
// bits set): K4's wgrad, whose K dimension is the rows of its operands.
// The no-swizzle MN-major core matrix is 8 MN-contiguous elements × 8 K
// rows 16 bytes apart; desc_mn gives the byte strides between core
// matrices along K (lbo) and along MN (sbo).
__device__ __forceinline__ void mma_mn_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_mn_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_mn_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_mn_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <int N>
__device__ __forceinline__ void mma_mn(float (&d)[N / 2], uint64_t da,
                                       uint64_t db);
template <>
__device__ __forceinline__ void mma_mn<256>(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  mma_mn_n256(d, da, db);
}
template <>
__device__ __forceinline__ void mma_mn<128>(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  mma_mn_n128(d, da, db);
}
template <>
__device__ __forceinline__ void mma_mn<64>(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  mma_mn_n64(d, da, db);
}
template <>
__device__ __forceinline__ void mma_mn<16>(float (&d)[8], uint64_t da,
                                           uint64_t db) {
  mma_mn_n16(d, da, db);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc = A·B over one weight slice of kk rows (kk a multiple of 16): A is
// the activation tile at a_addr (a_K columns, starting at column a_k), B the
// slice at b_addr. Issues kk/16 wgmmas; zero_first starts from 0.
template <int N>
__device__ __forceinline__ void mma_slice(float (&acc)[N / 2],
                                          uint32_t a_addr, int a_K, int a_k,
                                          uint32_t b_addr, int kk,
                                          bool zero_first) {
  for (int ks = 0; ks < kk; ks += 16) {
    mma<N>(acc, desc(a_addr + cm_off(0, a_k + ks, a_K), a_K * 16),
           desc(b_addr + cm_off(0, ks, kk), kk * 16),
           (zero_first && ks == 0) ? 0 : 1);
  }
}

// Moves registers between the warpgroups of a warp-specialised block; every
// warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Makes generic-proxy shared-memory stores (the epilogue) visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier over the 128 threads of one warpgroup (ids 1, 2, ...).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// Barrier over the two consumer warpgroups (256 threads, id 3).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// ---- mbarriers and bulk copies -----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// Asynchronous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- persistent scheduling ----------------------------------------------

// The live predication tiles of a launch, in order: every CUDA block scans
// every tile (tile = rpt rays; live(ray) says whether a ray keeps its tile
// alive) and compacts the live ones into list[0 .. return). A dead tile is
// handed to dead(tile) by the one block that owns it (tile % gridDim.x).
// Every thread of the block must call it; it ends with __syncthreads.
template <class Live, class Dead>
__device__ int live_tiles(int n_tiles, int rpt, uint8_t* flags,
                          uint16_t* list, int* n_live, Live live,
                          Dead dead) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    int any = 0;
    for (int i = lane; i < rpt; i += 32) any |= live((long)tile * rpt + i);
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) flags[tile] = (uint8_t)any;
    if (!any && tile % gridDim.x == blockIdx.x) dead(tile, lane);
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int tile = base + lane;
      const bool lv = tile < n_tiles && flags[tile];
      const unsigned m = __ballot_sync(0xffffffffu, lv);
      if (lv) list[n + __popc(m & ((1u << lane) - 1u))] = (uint16_t)tile;
      n += __popc(m);
    }
    if (lane == 0) *n_live = n;
  }
  __syncthreads();
  return *n_live;
}

// ---- work units of the marches -------------------------------------------

// A march launch's work comes in units: at SB <= 128 a unit is one work
// item of 128 rows (64/SB whole rays a warpgroup, or half a ray at 128);
// at SB > 128 a ray's block spans SB/128 items, and the unit is the ray:
// one CUDA block runs its items in order and carries the ray's log-T
// prefix from one to the next. unit_rows: the rows of a unit; unit_items:
// its items.
__host__ __device__ __forceinline__ int unit_rows(int SB) {
  return SB > kItemRows ? SB : kItemRows;
}
__host__ __device__ __forceinline__ int unit_items(int SB) {
  return SB > kItemRows ? SB / kItemRows : 1;
}
// First row of warpgroup g's 64 rows in item k of unit u (live: the
// launch's live tiles, tile_rows rows each).
__device__ __forceinline__ long unit_row0(const uint16_t* live, int u, int k,
                                          int g, int tile_rows, int SB) {
  const int upt = tile_rows / unit_rows(SB);
  return (long)live[u / upt] * tile_rows + (long)(u % upt) * unit_rows(SB) +
         k * kItemRows + kWgRows * g;
}

// ---- compositing ---------------------------------------------------------

// The samples a block the marches take: the reference's rule, a power of
// two whose tile of tile_rows/SB rays is a multiple of 4 rays (its row
// interleave), so 1..512 at tile_rows 2048 and 1..256 at 1024.
__host__ __device__ __forceinline__ bool march_sb_ok(int SB, int tile_rows) {
  return SB >= 1 && SB <= 512 && (SB & (SB - 1)) == 0 &&
         tile_rows % SB == 0 && (tile_rows / SB) % 4 == 0;
}

// Samples of a ray's block at SB >= 128 are composited an item at a time by
// one warp: 128 samples, kLongQ consecutive ones a lane.
constexpr int kLongQ = kItemRows / 32;

// Inclusive prefix sum over aligned segments of `seg` lanes (a power of 2).
__device__ __forceinline__ float seg_scan(float v, int seg) {
  const int pos = (threadIdx.x & 31) & (seg - 1);
  for (int o = 1; o < seg; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o, seg);
    if (pos >= o) v += u;
  }
  return v;
}
// Sum over aligned segments of `seg` lanes, returned in every lane.
__device__ __forceinline__ float seg_sum(float v, int seg) {
  for (int o = seg >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace wg
}  // namespace fnt
