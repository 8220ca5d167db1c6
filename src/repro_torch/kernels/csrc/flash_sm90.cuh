// Hopper (sm_90a) building blocks of the bf16 kernels (flash_attention.cu,
// flash_attention_bwd.cu, decode_attention.cu, ssd_scan.cu): swizzled
// shared-memory tiles, wgmma descriptors and instructions, mbarriers and
// named barriers, TMA, bulk and cp.async copies, ldmatrix and mma.sync,
// and the host-side tensor map.
//
// Tile layout.  A tile of R rows by D bf16 columns is NH = 2D / W column
// panels of R rows of W = min(128, 2D) bytes, panel after panel; inside a
// panel the 16-byte chunks of a row are XOR-swizzled exactly as TMA's
// SWIZZLE_<W>B mode writes them (chunk ^= (byte offset >> 7) mod W/16) and
// as wgmma's descriptor layout types 1 / 2 / 3 (128 / 64 / 32-byte
// swizzle) read them.  Every tile starts on a 1024-byte boundary, so the
// swizzle of an offset is the swizzle of its address.
#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {
namespace sm90 {

constexpr int kWarpgroup = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int D>
struct Tile {
  static constexpr int W = D >= 64 ? 128 : 2 * D;   // bytes a panel row
  static constexpr int NH = 2 * D / W;              // column panels
  static constexpr int kLayout = W == 128 ? 1 : W == 64 ? 2 : 3;
  static constexpr int kKSteps = W / 32;            // k16 steps a panel

  __device__ __forceinline__ static uint32_t swizzle(uint32_t x) {
    return x ^ (((x >> 7) & (W / 16 - 1)) << 4);
  }
  // byte offset of element (r, c) in a tile of R rows
  __device__ __forceinline__ static uint32_t offset(int R, int r, int c) {
    return swizzle(uint32_t((c / (W / 2)) * R * W + r * W +
                            (c % (W / 2)) * 2));
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (K-major swizzled: stride = 8 rows, leading unused;
// MN-major: leading = the next panel of the MN dimension, stride = 8 rows
// of K), layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(layout) << 62);
}

// An m64nN fp32 accumulator of one warpgroup: thread t of warp w holds
// rows 16w + t/4 (x[4j], x[4j+1]) and 16w + t/4 + 8 (x[4j+2], x[4j+3]) at
// columns 8j + 2(t%4) and 8j + 2(t%4) + 1.
template <int N>
struct Frag {
  float x[N / 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) x[i] = 0.f;
  }
  // keep the compiler from moving reads or writes across an async wgmma
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(x[i])::"memory");
  }
};

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error ~2^-22,
// results below 2^-126 flush to 0), without exp2f's subnormal handling
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN fp32 accumulator as the A operand (bf16, registers) of the next
// product over its N columns: k16 step kk is a[4kk .. 4kk + 3].
template <int N>
__device__ __forceinline__ void to_a_operand(const Frag<N>& f,
                                             uint32_t (&a)[N / 4]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) a[i] = pack_bf16(f.x[2 * i], f.x[2 * i + 1]);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F8(i) WG_F4(i), WG_F4(i + 4)
#define WG_F16(i) WG_F8(i), WG_F8(i + 8)
#define WG_F32(i) WG_F16(i), WG_F16(i + 16)

// D (+)= A B, m64nNk16, bf16 in, fp32 accumulate.  wgmma_ss: A and B from
// shared memory (TA / TB = 1: MN-major); wgmma_rs: A from registers.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(Frag<8>& acc, uint64_t da,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, %7, %8;\n}\n"
      : WG_F4(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(Frag<16>& acc, uint64_t da,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : WG_F8(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Frag<16>& acc, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : WG_F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(Frag<32>& acc, uint64_t da,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : WG_F16(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Frag<32>& acc, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : WG_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(Frag<64>& acc, uint64_t da,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_F32(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Frag<64>& acc, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(Frag<128>& acc, uint64_t da,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_F32(0), WG_F32(32)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Frag<128>& acc, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : WG_F32(0), WG_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// m64n256k16 with A from registers: the D 256 forward's O += P V
template <int TB>
__device__ __forceinline__ void wgmma_rs(Frag<256>& acc, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  float* d = acc.x;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : WG_F32(0), WG_F32(32), WG_F32(64), WG_F32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

#undef WG_F4
#undef WG_F8
#undef WG_F16
#undef WG_F32

// ---- barriers and copies --------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// TMA: a box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// global fp32 += shared fp32, `bytes` (a multiple of 16; both addresses
// 16-byte aligned) added by the TMA unit, in this thread's bulk group
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst,
                                                    const void* src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// 16 bytes global -> shared; zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's count includes this arrival)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8x8 b16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8); .trans hands out their transposes
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// arrive on named barrier `id` without waiting: this thread's earlier
// shared-memory writes are seen by the threads that wait on it (bar.sync)
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Copy folded rows [r0, r0 + R) of KV head h of a (B, S, Hq, D) bf16
// tensor (element strides sb, ss, sh) into an R-row swizzled tile by
// 16-byte cp.async, as thread t of n (n a multiple of D / 8); rows past SG
// read 0.  Row s * G + g is src[b, s, h * G + g]; (s, g) advance without
// a division per row.
template <int D, int R>
__device__ __forceinline__ void load_rows_async(
    uint8_t* tile, const __nv_bfloat16* src, int r0, int SG, int G, int h,
    int b, long long sb, long long ss, long long sh, int t, int n) {
  constexpr int kChunks = D / 8;
  const int c = (t % kChunks) * 8, step = n / kChunks;
  const int ds = step / G, dg = step - ds * G;
  int r = t / kChunks, row = r0 + r;
  int s = row / G, g = row - s * G;
  for (; r < R; r += step) {
    const bool ok = row < SG;
    cp_async16(tile + Tile<D>::offset(R, r, c),
               ok ? src + b * sb + s * ss + (long long)(h * G + g) * sh + c
                  : src,
               ok);
    row += step;
    s += ds;
    g += dg;
    if (g >= G) {
      g -= G;
      ++s;
    }
  }
}

// dynamic shared memory, rounded up to 1024 bytes (the launch adds 1024)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- host: tensor maps ---------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so nothing links libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a (B, L, H, D) bf16 tensor with element strides sb, sl, sh
// (last dim contiguous) as dims (D, H, L, B), box (W/2, box_h, box_l, 1):
// one load fills one column panel of a tile of box_h * box_l rows, row
// l * box_h + h.  Rows past L read 0.  Returns a cudaError_t (0 = success).
template <int D>
inline int tensor_map(CUtensorMap* map, const void* base, int B, int L,
                      int H, long long sb, long long sl, long long sh,
                      int box_h, int box_l) {
  using Tl = Tile<D>;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(L),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(sl) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(Tl::W / 2), cuuint32_t(box_h),
                             cuuint32_t(box_l), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = Tl::W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : Tl::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

}  // namespace sm90
}  // namespace flash
