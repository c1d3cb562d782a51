// Attention backward, dK and dV, for Hopper: one ring step, and flash
// attention as the one-step ring.
//
// Replaces the dK/dV half of maggy_tpu/ops/ring_flash.py::_ring_bwd_kernel
// (launched by _ring_bwd_local): at one ring step, the visiting KV chunk's
// dV += P^T dO and dK += dS^T Q from the local q chunk, with P recomputed from
// the forward's LSE, delta = rowsum(dO * O) recomputed per q tile from the O
// and dO tiles (as the TPU kernel does per tile, :539), and the GQA group
// summed. The TPU kernel folded these into fp32 (dk, dv) accumulators that
// rotate with the chunk (:549-558, :635-650); this kernel (Out = float)
// reads, adds and writes the same fp32 accumulators of the visiting chunk in
// device memory, storing them on the chunk's first step instead. The ring
// moves them; the caller casts them to bf16 once, after the last rotation
// (:750-752).
//
// Also replaces maggy_tpu/ops/flash.py::_dkv_kernel (launched by _bwd_call)
// and the GQA group sum in _flash_core's core_bwd: flash attention's dK/dV
// is the one-step ring with diagonal = causal, one segment array for q and
// k, and dK/dV stored in the input type (Out = T). The TPU kernel wrote
// per-q-head gradients [B*H, S, D] and the caller summed each group; here
// the group sum happens in registers, with no [B, S, H, D] intermediate.
//
// One CTA per (KV tile of 64 rows, KV head, batch) loops over the group's q
// heads and the local q tiles (those at or below the diagonal on the diagonal
// step, all of them for a past chunk), accumulating in fp32 registers, and
// writes its tile once: each CTA owns its rows, so there are no atomics. The
// products are taken as S^T = K Q^T and dP^T = V dO^T, so each warp owns 16
// KV rows and never reduces across warps. The q and KV chunks carry separate
// segment ids.
//
// Bound on the H100: four 64x64xD products per tile pair against about 6 * D
// bytes streamed per q row: bound by tensor-core operations. This first
// version uses mma.sync from single-buffered shared tiles.
#include "flash_common.cuh"

namespace mt {

struct RingDkvArgs {
  const uint16_t* q; const uint16_t* k; const uint16_t* v; const uint16_t* o; const uint16_t* dout;
  const float* lse; const int* qsegs; const int* ksegs; void* dk; void* dv;  // float or T: Out
  int H, KH, C, diagonal, first; float scale;
  Strides qs, ks, vs, os, dos, dks, dvs;
  RowStrides st;  // lse
  long long qseg_b, kseg_b;
};

template <int D, typename T, typename Out>
__global__ void __launch_bounds__(NT) ring_dkv_kernel(const RingDkvArgs a) {
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
  const int* qsegs = a.qsegs ? a.qsegs + b * a.qseg_b : nullptr;
  const int* ksegs = a.ksegs ? a.ksegs + b * a.kseg_b : nullptr;

  load_tile<D>(sK, a.k + b * a.ks.b + kh * a.ks.h, a.ks.s, n0, a.C, tid);
  load_tile<D>(sV, a.v + b * a.vs.b + kh * a.vs.h, a.vs.s, n0, a.C, tid);
  const int lr = warp * 16 + (lane >> 2);
  const int krow[2] = {n0 + lr, n0 + lr + 8};
  int kseg[2] = {0, 0};
  if (ksegs) {
    for (int r = 0; r < 2; ++r) kseg[r] = krow[r] < a.C ? ksegs[krow[r]] : -2;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;

  // on the diagonal a KV tile receives gradient only from q tiles at or after it
  const int q_begin = a.diagonal ? (n0 / BM) * BM : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kh * group + hh;
    const float* lse = a.lse + b * a.st.b + h * a.st.h;
    for (int q0 = q_begin; q0 < a.C; q0 += BM) {
      __syncthreads();  // the previous q tile is consumed
      load_tile<D>(sQ, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.C, tid);
      load_tile<D>(sdO, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.C, tid);
      load_tile<D>(sO, a.o + b * a.os.b + h * a.os.h, a.os.s, q0, a.C, tid);
      load_segs(sSeg, qsegs, q0, a.C, tid);
      for (int i = tid; i < BM; i += NT) sLse[i] = q0 + i < a.C ? lse[q0 + i] : INFINITY;
      __syncthreads();
      row_dot<D, T>(sDelta, sdO, sO, tid);
      __syncthreads();

      // P^T = exp(K Q^T * scale - lse[q]) with the step's mask
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
          const bool ok = qrow < a.C && (!a.diagonal || krow[r] <= qrow) && (!qsegs || kseg[r] == sSeg[cl]);
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
    if (krow[r] >= a.C) continue;
    Out* pk = static_cast<Out*>(a.dk) + b * a.dks.b + kh * a.dks.h + (long long)krow[r] * a.dks.s;
    Out* pv = static_cast<Out*>(a.dv) + b * a.dvs.b + kh * a.dvs.h + (long long)krow[r] * a.dvs.s;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      put2<T>(pk + dt * 8 + tig * 2, dk[dt][2 * r], dk[dt][2 * r + 1], a.first);
      put2<T>(pv + dt * 8 + tig * 2, dv[dt][2 * r], dv[dt][2 * r + 1], a.first);
    }
  }
}

template <int D, typename T, typename Out>
int launch(const RingDkvArgs& a, int B, cudaStream_t stream) {
  const int smem = 5 * tile_elems(D) * 2 + 3 * BM * 4;
  cudaFuncSetAttribute(ring_dkv_kernel<D, T, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((a.C + BN - 1) / BN, a.KH, B);
  ring_dkv_kernel<D, T, Out><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 q/k/v/o/dO and fp32 LSE. dK/dV are fp32 accumulators with
// `accumulate` (stored on the chunk's first step, added to after), else bf16
// and stored. Returns cudaGetLastError() after the launch, or -1 for a
// head_dim this kernel does not take.
extern "C" int mt_ring_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* qsegs, const void* ksegs, void* dk, void* dv,
    int B, int H, int KH, int C, int D, int diagonal, int first, int accumulate, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    long long st_sb, long long st_sh, long long qseg_sb, long long kseg_sb,
    void* stream) {
  mt::RingDkvArgs a{};
  a.q = static_cast<const uint16_t*>(q); a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v); a.o = static_cast<const uint16_t*>(o);
  a.dout = static_cast<const uint16_t*>(dout); a.lse = static_cast<const float*>(lse);
  a.qsegs = static_cast<const int*>(qsegs); a.ksegs = static_cast<const int*>(ksegs);
  a.dk = dk; a.dv = dv;
  a.H = H; a.KH = KH; a.C = C; a.diagonal = diagonal; a.first = first; a.scale = scale;
  a.qs = {q_sb, q_ss, q_sh}; a.ks = {k_sb, k_ss, k_sh}; a.vs = {v_sb, v_ss, v_sh};
  a.os = {o_sb, o_ss, o_sh}; a.dos = {do_sb, do_ss, do_sh};
  a.dks = {dk_sb, dk_ss, dk_sh}; a.dvs = {dv_sb, dv_ss, dv_sh};
  a.st = {st_sb, st_sh}; a.qseg_b = qseg_sb; a.kseg_b = kseg_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (D == 128) return accumulate ? mt::launch<128, bf16, float>(a, B, st) : mt::launch<128, bf16, uint16_t>(a, B, st);
  if (D == 64) return accumulate ? mt::launch<64, bf16, float>(a, B, st) : mt::launch<64, bf16, uint16_t>(a, B, st);
  return -1;
}
