// Hopper (sm_90a) building blocks of the three attention kernels,
// ring_fwd.cu, ring_bwd_dq.cu and ring_bwd_dkv.cu: mbarriers, TMA tile
// loads, wgmma descriptors and products, and the register hand-over between
// a producer and its consumers.
//
// Tiles in shared memory. TMA copies a tile of R rows and D columns of a
// [B, S, H, D] tensor as D / 64 panels of R x 64 bf16 (128 bytes a row), each
// panel 128-byte swizzled (CU_TENSOR_MAP_SWIZZLE_128B) and 1024-byte aligned.
// wgmma reads such a tile through a descriptor, in one of two ways:
// - K-major (the product's depth runs along the 64 columns; S = Q K^T takes
//   Q and K so): 8-row groups 1024 bytes apart (SBO); a depth step of 16
//   columns moves the start 32 bytes within a panel, or to the next panel.
// - MN-major (the depth runs along the rows; P V takes V so, dS K takes K
//   so, the transpose bit set): 8-row depth groups 1024 bytes apart (SBO),
//   the next 64 output columns one panel further (LBO); a depth step of 16
//   rows moves the start 2048 bytes.
// A tile that threads store themselves for wgmma to read (ring_bwd_dkv.cu's
// P^T and dS^T) follows the same pattern: the 16-byte chunk c of row r lies
// at r * 128 + (c ^ (r % 8)) * 16, then fence_async_smem and a barrier.
// The accumulator of a 64 x N product lives in the four warps of a
// warpgroup: warp w holds rows 16w + g and 16w + g + 8 (g = lane / 4) and,
// for each 8-column block j, d[4j + 0..1] on the first row and d[4j + 2..3]
// on the second, at columns 8j + 2 (lane % 4) + 0..1. Its 16-column slices,
// rounded to bf16, are the register A operand of the next product (pack_a).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time, nothing links libcuda
#include <cuda_runtime.h>

#include "attn_common.cuh"

namespace mt {
namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
// Until the phase of parity `parity` has completed (a fresh barrier counts
// its phase before the first as completed, of parity 1). A wait that lasts
// about 20 s (a copy or an arrival that never comes) traps, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > 40000000000ll) __trap();
  }
}

// ---- TMA --------------------------------------------------------------------

// Rows row..row+R-1 of head `head`, batch `batch` of a tensor map made by
// encode_rows (boxes of 64 columns by R rows) into R x D at `dst`, as D / 64
// panels; rows past the tensor's end arrive as zeros. Completes on `bar`
// with R * D * 2 bytes.
template <int D, int R>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int row, int head,
                                         int batch) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int p = 0; p < D / 64; ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst + p * R * 128),
        "l"(m), "r"(smem_u32(bar)), "r"(p * 64), "r"(head), "r"(row), "r"(batch)
        : "memory");
  }
}

// ---- wgmma ------------------------------------------------------------------

// A shared-memory address the compiler cannot see through. Descriptors made
// from it inside a loop are made where the products use them, instead of
// being hoisted out of the loop into 64-bit registers live across all of it.
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return addr;
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// Depth step `k` (16 columns) of a K-major operand: the tile at `tile` has R
// rows per panel; the operand's rows start at the tile's first row.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int k) {
  return sw128_desc(tile + (k / 4) * R * 128 + (k % 4) * 32, 16, 1024);
}
// Depth step `k` (16 rows) of an MN-major operand in a tile of R rows per panel.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k) {
  return sw128_desc(tile + k * 2048, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory stores of this thread made visible to wgmma (the async
// proxy); then a barrier makes them visible to the other warpgroup's too.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// The `threads` threads of the consumer warpgroups meet at barrier `id`
// (1-15; 0 is __syncthreads, which the whole CTA would have to reach).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Tells the compiler that an asynchronous product reads or writes these
// registers here, so it moves no access to them across a fence or a wait.
template <int N>
__device__ __forceinline__ void touch(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 16-column slice k of a 64 x N fp32 accumulator, rounded to T, as the
// register A operand of a product.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t a[4], const float* d, int k) {
  a[0] = pack<T>(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack<T>(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack<T>(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack<T>(d[8 * k + 6], d[8 * k + 7]);
}

// m64nNk16, bf16 in, fp32 accumulate; scale_d = 0 overwrites d. A from
// shared memory is read K-major.
template <int N>
struct Wgmma;

template <> struct Wgmma<32> {
  // d[16] (+)= A * B, A (K-major) and B in shared memory; TransB = 1 reads B
  // MN-major (N contiguous)
  template <int TransB>
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
};

template <> struct Wgmma<64> {
  // d[32] (+)= A * B, A (K-major) and B in shared memory; TransB = 1 reads B
  // MN-major (N contiguous)
  template <int TransB>
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
  // d[32] (+)= A * B, A in registers (four bf16 pairs), B in shared memory
  template <int TransB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
  }
};

template <> struct Wgmma<128> {
  // d[64] (+)= A * B, A (K-major) and B in shared memory; TransB = 1 reads B
  // MN-major (N contiguous)
  template <int TransB>
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
  // d[64] (+)= A * B, A in registers (four bf16 pairs), B in shared memory
  template <int TransB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
  }
};

// ---- registers and exponentials ---------------------------------------------

// A warpgroup hands registers back (producer) or takes them (consumers).
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hopper

// ---- host: tensor maps ------------------------------------------------------

// A tensor map over a bf16 [batch, rows, heads, D] tensor with the given
// element strides (the last dimension contiguous, the others multiples of 8
// elements), read in boxes of 64 columns by box_rows rows, 128-byte swizzled,
// zero past its edges. Dimensions run (D, heads, rows, batch) so that the
// strides grow for a [B, S, H, D] layout. 0 on success, -2 if the driver's
// encoder is missing, -3 if it refuses the tensor.
inline int encode_rows(CUtensorMap* map, const void* base, int D, int rows, int heads, int batch,
                       long long s_stride, long long h_stride, long long b_stride, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = []() -> Encode {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  if (encode == nullptr) return -2;
  // The encoder works in the calling thread's current context. A thread
  // that has made no runtime call yet (such as PyTorch's autograd thread
  // before its first launch) has none, and the encoder then refuses every
  // tensor: bind the current device's primary context first.
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || cudaSetDevice(device) != cudaSuccess) return -3;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(h_stride) * 2, static_cast<cuuint64_t>(s_stride) * 2,
                                 static_cast<cuuint64_t>(b_stride) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

}  // namespace mt
