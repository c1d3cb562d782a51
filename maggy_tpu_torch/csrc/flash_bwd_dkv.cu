// Flash-attention backward, dK and dV, for Hopper.
//
// Replaces maggy_tpu/ops/flash.py::_dkv_kernel (launched by _bwd_call) AND
// the GQA group sum in _flash_core's core_bwd: dV = sum_q P^T dO and
// dK = sum_q dS^T Q, with P recomputed from the LSE, delta = rowsum(dO * O)
// recomputed per q tile from the O and dO tiles, and the full causal,
// segment and ragged-edge mask re-applied.
//
// The TPU kernel wrote per-q-head gradients [B*H, S, D] because a KV block
// could not accumulate across grid revisits; the caller then summed each
// group in fp32. Here one CTA per (KV tile of 64 rows, KV head, batch) loops
// over the group's q heads and all q tiles at or below the causal diagonal,
// accumulating dK and dV in fp32 registers, and writes them once per KV head:
// no atomics and no [B, S, H, D] intermediate. The products are taken as
// S^T = K Q^T and dP^T = V dO^T, so each warp owns 16 KV rows and never
// needs a cross-warp reduction.
//
// Bound on the H100: four 64x64xD products per tile pair against about
// 6 * D bytes streamed per q row: bound by tensor-core operations. This first
// version uses mma.sync from single-buffered shared tiles.
#include "flash_common.cuh"

namespace mt {

template <int D, typename T>
__global__ void __launch_bounds__(NT) dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sV = sK + tile_elems(D);
  uint16_t* sQ = sV + tile_elems(D);
  uint16_t* sdO = sQ + tile_elems(D);
  uint16_t* sO = sdO + tile_elems(D);
  float* sLse = reinterpret_cast<float*>(sO + tile_elems(D));
  float* sDelta = sLse + BM;
  int* sSeg = reinterpret_cast<int*>(sDelta + BM);
  constexpr int LD = pitch(D);

  const int n0 = blockIdx.x * BN;
  const int kh = blockIdx.y, b = blockIdx.z, group = a.H / a.KH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const int* segs = a.segs ? a.segs + (long long)b * a.Sk : nullptr;

  load_tile<D>(sK, a.k + b * a.ks.b + kh * a.ks.h, a.ks.s, n0, a.Sk, tid);
  load_tile<D>(sV, a.v + b * a.vs.b + kh * a.vs.h, a.vs.s, n0, a.Sk, tid);
  const int lr = warp * 16 + (lane >> 2);
  const int krow[2] = {n0 + lr, n0 + lr + 8};
  int kseg[2] = {0, 0};
  if (segs) {
    for (int r = 0; r < 2; ++r) kseg[r] = krow[r] < a.Sk ? segs[krow[r]] : -2;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;

  // a KV tile receives gradient only from q tiles at or after the diagonal
  const int q_begin = a.causal ? (n0 / BM) * BM : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kh * group + hh;
    const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;
    for (int q0 = q_begin; q0 < a.Sq; q0 += BM) {
      __syncthreads();  // the previous q tile is consumed
      load_tile<D>(sQ, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.Sq, tid);
      load_tile<D>(sdO, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.Sq, tid);
      load_tile<D>(sO, a.o + b * a.os.b + h * a.os.h, a.os.s, q0, a.Sq, tid);
      load_segs(sSeg, segs, q0, a.Sq, tid);
      for (int i = tid; i < BM; i += NT) sLse[i] = q0 + i < a.Sq ? lse[q0 + i] : INFINITY;
      __syncthreads();
      row_dot<D, T>(sDelta, sdO, sO, tid);
      __syncthreads();

      // P^T = exp(K Q^T * scale - lse[q]) with the forward's mask
      float pt[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) pt[i][0] = pt[i][1] = pt[i][2] = pt[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ak[4];
        load_a(ak, sK, LD, warp * 16, kk, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t bq[2];
          load_bt(bq, sQ, LD, nt * 8, kk, lane);
          mma<T>(pt[nt], ak, bq);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, cl = nt * 8 + tig * 2 + (e & 1), qrow = q0 + cl;
          const bool ok = qrow < a.Sq && (!a.causal || krow[r] <= qrow) && (!segs || kseg[r] == sSeg[cl]);
          pt[nt][e] = ok ? __expf(pt[nt][e] * a.scale - sLse[cl]) : 0.f;
        }
      }
      // dV += P^T dO
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t pa[4];
        acc_to_a<T>(pa, pt, j);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          uint32_t bd[2];
          load_b(bd, sdO, LD, j * 16, dt * 8, lane);
          mma<T>(dv[dt], pa, bd);
        }
      }
      // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta[q]) * scale
      float dpt[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t av[4];
        load_a(av, sV, LD, warp * 16, kk, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t bd[2];
          load_bt(bd, sdO, LD, nt * 8, kk, lane);
          mma<T>(dpt[nt], av, bd);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + tig * 2 + (e & 1);
          dpt[nt][e] = pt[nt][e] * (dpt[nt][e] - sDelta[cl]) * a.scale;
        }
      }
      // dK += dS^T Q
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t da[4];
        acc_to_a<T>(da, dpt, j);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          uint32_t bq[2];
          load_b(bq, sQ, LD, j * 16, dt * 8, lane);
          mma<T>(dk[dt], da, bq);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= a.Sk) continue;
    uint16_t* pk = a.dk + b * a.dks.b + kh * a.dks.h + (long long)krow[r] * a.dks.s;
    uint16_t* pv = a.dv + b * a.dvs.b + kh * a.dvs.h + (long long)krow[r] * a.dvs.s;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(pk + dt * 8 + tig * 2) = pack<T>(dk[dt][2 * r], dk[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(pv + dt * 8 + tig * 2) = pack<T>(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

template <int D, typename T>
int launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const int smem = 5 * tile_elems(D) * 2 + 3 * BM * 4;
  cudaFuncSetAttribute(dkv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((a.Sk + BN - 1) / BN, a.KH, B);
  dkv_kernel<D, T><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 operands. Returns cudaGetLastError() after the launch, or -1 for a
// head_dim this kernel does not take.
extern "C" int mt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* segs, void* dk, void* dv,
    int B, int H, int KH, int Sq, int Sk, int D, int causal, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    void* stream) {
  mt::BwdArgs a{};
  a.q = static_cast<const uint16_t*>(q); a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v); a.o = static_cast<const uint16_t*>(o);
  a.dout = static_cast<const uint16_t*>(dout); a.lse = static_cast<const float*>(lse);
  a.segs = static_cast<const int*>(segs);
  a.dk = static_cast<uint16_t*>(dk); a.dv = static_cast<uint16_t*>(dv);
  a.H = H; a.KH = KH; a.Sq = Sq; a.Sk = Sk; a.causal = causal; a.scale = scale;
  a.qs = {q_sb, q_ss, q_sh}; a.ks = {k_sb, k_ss, k_sh}; a.vs = {v_sb, v_ss, v_sh};
  a.os = {o_sb, o_ss, o_sh}; a.dos = {do_sb, do_ss, do_sh};
  a.dks = {dk_sb, dk_ss, dk_sh}; a.dvs = {dv_sb, dv_ss, dv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return mt::launch<128, __nv_bfloat16>(a, B, st);
  if (D == 64) return mt::launch<64, __nv_bfloat16>(a, B, st);
  return -1;
}
