// What every attention kernel shares besides the Hopper pieces of
// hopper.cuh: the masking value, bf16 conversion, the stride structs and the
// output store.
//
// Layouts: q/o/do are [B, C, H, D], k/v [B, C, Kh, D], read through their
// strides (the last dimension contiguous, the others multiples of 8 elements
// so 16-byte rows stay aligned). The LSE and the running max and sum are
// fp32 [B, H, C] read through RowStrides. Segment ids are int32 [B, C], one
// array for the q chunk and one for the KV chunk (the same array twice for
// self-attention over the whole sequence).
//
// The three kernels (ring_fwd.cu, ring_bwd_dq.cu, ring_bwd_dkv.cu) compute
// one ring step each; flash attention over a whole sequence is the one-step
// ring (first and last step at once, diagonal = causal), so each tile loop
// exists once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mt {

constexpr float NEG_INF = -1e30f;  // the JAX package's masking value

// ---- element conversion ---------------------------------------------------
// The element type T is a template parameter of every kernel; bf16 is the one
// the model computes in and the one specialised here.

template <typename T> __device__ __forceinline__ float to_f(uint16_t x);
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

template <typename T> __device__ __forceinline__ uint32_t pack(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides {
  long long b, s, h;  // batch, sequence and head strides in elements
};

// A [B, H, rows] fp32 array with unit row stride (LSE, running max and sum).
struct RowStrides {
  long long b, h;
};

// Two neighbouring values of an output row. An fp32 accumulator is stored on
// its chunk's first ring step and added to afterwards; an output in the
// element type T (one-step flash attention) is stored.
template <typename T>
__device__ __forceinline__ void put2(float* p, float x, float y, bool first) {
  float2* q = reinterpret_cast<float2*>(p);
  if (first) {
    *q = make_float2(x, y);
  } else {
    const float2 old = *q;
    *q = make_float2(old.x + x, old.y + y);
  }
}
template <typename T>
__device__ __forceinline__ void put2(uint16_t* p, float x, float y, bool) {
  *reinterpret_cast<uint32_t*>(p) = pack<T>(x, y);
}

}  // namespace mt
