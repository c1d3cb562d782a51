// The mma.sync pieces of the dQ kernel (ring_bwd_dq.cu), Ampere's design
// carried over in the port's first slice; the forward and dK/dV kernels use
// Hopper's wgmma and TMA instead (hopper.cuh).
//
// Tiles: every CTA owns a 64-row tile and streams 64-row tiles of the other
// operand through shared memory. Four warps each own 16 of the CTA's rows and
// multiply with mma.sync m16n8k16 (bf16 in, fp32 accumulate). Tiles
// sit in shared memory row-major with a row pitch of D + 8 elements, so the
// 32-bit fragment loads of one warp fall in 32 different banks.
#pragma once

#include "attn_common.cuh"

namespace mt {

constexpr int BM = 64;    // rows of the CTA's own tile
constexpr int BN = 64;    // rows of each streamed tile
constexpr int NT = 128;   // threads: 4 warps x 16 rows

__host__ __device__ constexpr int pitch(int d) { return d + 8; }
__host__ __device__ constexpr int tile_elems(int d) { return BM * pitch(d); }

// ---- tensor-core product: c[16x8] += a[16x16] * b[16x8] -------------------

template <typename T> __device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]);
template <> __device__ __forceinline__ void mma<__nv_bfloat16>(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- fragments from a shared tile (lane = 4 * group + tig) ----------------
// A (16x16, row-major): rows r0.., cols c0.. of the tile.
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* s, int ld, int r0, int c0, int lane) {
  const uint16_t* p = s + (r0 + (lane >> 2)) * ld + c0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}
// B (16x8) with B[k][n] = tile[n0 + n][k0 + k]: a product with the tile's transpose.
__device__ __forceinline__ void load_bt(uint32_t b[2], const uint16_t* s, int ld, int n0, int k0, int lane) {
  const uint16_t* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3) * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}
// B (16x8) with B[k][n] = tile[k0 + k][n0 + n]: a product with the tile itself.
__device__ __forceinline__ void load_b(uint32_t b[2], const uint16_t* s, int ld, int k0, int n0, int lane) {
  const uint16_t* p = s + (k0 + (lane & 3) * 2) * ld + n0 + (lane >> 2);
  b[0] = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[ld]) << 16);
  b[1] = static_cast<uint32_t>(p[8 * ld]) | (static_cast<uint32_t>(p[9 * ld]) << 16);
}
// The accumulator of a 16x64 product (8 n-tiles of 16x8) as the A operand of
// k-step j (columns 16j..16j+15), rounded to T.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c[8][4], int j) {
  a[0] = pack<T>(c[2 * j][0], c[2 * j][1]);
  a[1] = pack<T>(c[2 * j][2], c[2 * j][3]);
  a[2] = pack<T>(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack<T>(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// ---- global -> shared ------------------------------------------------------
// Rows row0..row0+63 of a [rows, D] matrix whose rows are `stride` elements
// apart; rows past `rows` are zero-filled (the ragged edge).
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* s, const uint16_t* g, long long stride, int row0, int rows, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < BM * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) v = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(s + r * pitch(D) + c) = v;
  }
}

// Segment ids of rows row0..row0+63 (-1 past the edge), or nothing if unsegmented.
__device__ __forceinline__ void load_segs(int* s, const int* segs, int row0, int rows, int tid) {
  if (segs == nullptr) return;
  for (int i = tid; i < BM; i += NT) s[i] = row0 + i < rows ? segs[row0 + i] : -1;
}

// delta[r] = sum_d dO[r, d] * O[r, d] in fp32 for the 64 rows of two tiles.
template <int D, typename T>
__device__ __forceinline__ void row_dot(float* delta, const uint16_t* sdo, const uint16_t* so, int tid) {
  const int r = tid >> 1, c0 = (tid & 1) * (D / 2);
  float acc = 0.f;
#pragma unroll 8
  for (int c = c0; c < c0 + D / 2; ++c) acc += to_f<T>(sdo[r * pitch(D) + c]) * to_f<T>(so[r * pitch(D) + c]);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if ((tid & 1) == 0) delta[r] = acc;
}

}  // namespace mt
