// Flash-attention backward, dQ, for Hopper.
//
// Replaces maggy_tpu/ops/flash.py::_dq_kernel (launched by _bwd_call):
// dQ = sum over KV tiles of dS K, with P = exp(s - lse) recomputed from the
// forward's LSE, delta = rowsum(dO * O) recomputed from the O and dO tiles
// inside the kernel (no separate pass), dS = P * (dP - delta) * scale, and
// the full causal, segment and ragged-edge mask re-applied.
//
// One CTA per (q tile of 64 rows, head, batch) holds its Q and dO tiles in
// shared memory and walks the KV tiles in a loop, where the TPU walked them
// as a sequential grid axis; dQ accumulates in fp32 registers. The KV head is
// h / group. Tiles above the causal diagonal are skipped.
//
// Bound on the H100: three 64x64xD products per tile pair (S, dP, dS K)
// against about 4 * D bytes read per row: bound by tensor-core operations.
// This first version uses mma.sync from single-buffered shared tiles.
#include "flash_common.cuh"

namespace mt {

template <int D, typename T>
__global__ void __launch_bounds__(NT) dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sdO = sQ + tile_elems(D);
  uint16_t* sK = sdO + tile_elems(D);
  uint16_t* sV = sK + tile_elems(D);
  float* sDelta = reinterpret_cast<float*>(sV + tile_elems(D));
  int* sSeg = reinterpret_cast<int*>(sDelta + BM);
  constexpr int LD = pitch(D);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const uint16_t* kp = a.k + b * a.ks.b + kh * a.ks.h;
  const uint16_t* vp = a.v + b * a.vs.b + kh * a.vs.h;
  const int* segs = a.segs ? a.segs + (long long)b * a.Sk : nullptr;

  load_tile<D>(sQ, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq, tid);
  load_tile<D>(sdO, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.Sq, tid);
  load_tile<D>(sK, a.o + b * a.os.b + h * a.os.h, a.os.s, q0, a.Sq, tid);  // O, only for delta
  __syncthreads();
  row_dot<D, T>(sDelta, sdO, sK, tid);
  __syncthreads();

  const int lr = warp * 16 + (lane >> 2);
  const int row[2] = {q0 + lr, q0 + lr + 8};
  float lse[2], delta[2] = {sDelta[lr], sDelta[lr + 8]};
  int qseg[2] = {0, 0};
  for (int r = 0; r < 2; ++r) {
    lse[r] = row[r] < a.Sq ? a.lse[((long long)b * a.H + h) * a.Sq + row[r]] : INFINITY;
    if (segs) qseg[r] = row[r] < a.Sq ? segs[row[r]] : -2;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int kv_end = a.causal ? min(a.Sk, q0 + BM) : a.Sk;
  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();  // sK held O (first pass) or the previous tile
    load_tile<D>(sK, kp, a.ks.s, n0, a.Sk, tid);
    load_tile<D>(sV, vp, a.vs.s, n0, a.Sk, tid);
    load_segs(sSeg, segs, n0, a.Sk, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ado[4];
      load_a(aq, sQ, LD, warp * 16, kk, lane);
      load_a(ado, sdO, LD, warp * 16, kk, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bk[2], bv[2];
        load_bt(bk, sK, LD, nt * 8, kk, lane);
        load_bt(bv, sV, LD, nt * 8, kk, lane);
        mma<T>(s[nt], aq, bk);   // S = Q K^T
        mma<T>(dp[nt], ado, bv); // dP = dO V^T
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, cl = nt * 8 + tig * 2 + (e & 1), col = n0 + cl;
        const bool ok = col < a.Sk && (!a.causal || col <= row[r]) && (!segs || qseg[r] == sSeg[cl]);
        const float p = ok ? __expf(s[nt][e] * a.scale - lse[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta[r]) * a.scale;  // dS
      }
    }
    // dQ += dS K, dS rounded to the input type as the TPU kernel does
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t da[4];
      acc_to_a<T>(da, s, j);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bk[2];
        load_b(bk, sK, LD, j * 16, dt * 8, lane);
        mma<T>(acc[dt], da, bk);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Sq) continue;
    uint16_t* out = a.dq + b * a.dqs.b + h * a.dqs.h + (long long)row[r] * a.dqs.s;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) = pack<T>(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

template <int D, typename T>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const int smem = 4 * tile_elems(D) * 2 + BM * 4 + BN * 4;
  cudaFuncSetAttribute(dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((a.Sq + BM - 1) / BM, a.H, B);
  dq_kernel<D, T><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 operands. Returns cudaGetLastError() after the launch, or -1 for a
// head_dim this kernel does not take.
extern "C" int mt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* segs, void* dq,
    int B, int H, int KH, int Sq, int Sk, int D, int causal, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    void* stream) {
  mt::BwdArgs a{};
  a.q = static_cast<const uint16_t*>(q); a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v); a.o = static_cast<const uint16_t*>(o);
  a.dout = static_cast<const uint16_t*>(dout); a.lse = static_cast<const float*>(lse);
  a.segs = static_cast<const int*>(segs); a.dq = static_cast<uint16_t*>(dq);
  a.H = H; a.KH = KH; a.Sq = Sq; a.Sk = Sk; a.causal = causal; a.scale = scale;
  a.qs = {q_sb, q_ss, q_sh}; a.ks = {k_sb, k_ss, k_sh}; a.vs = {v_sb, v_ss, v_sh};
  a.os = {o_sb, o_ss, o_sh}; a.dos = {do_sb, do_ss, do_sh}; a.dqs = {dq_sb, dq_ss, dq_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return mt::launch<128, __nv_bfloat16>(a, B, st);
  if (D == 64) return mt::launch<64, __nv_bfloat16>(a, B, st);
  return -1;
}
