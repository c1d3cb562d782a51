// Attention backward, dQ, for Hopper: one ring step, and flash attention as
// the one-step ring.
//
// Replaces the dQ half of maggy_tpu/ops/ring_flash.py::_ring_bwd_kernel
// (launched by _ring_bwd_local): at one ring step, the local q chunk's dQ
// against the visiting KV chunk, dQ += dS K, with P = exp(s - lse)
// recomputed from the forward's LSE and dS = P * (dP - delta) * scale. The
// TPU kernel kept dQ in an fp32 HBM accumulator and read, added and wrote it
// back per q tile at every step (:504-563); so does this kernel (Out =
// float), storing it on the rank's first step instead. The caller casts it
// to bf16 once, after the last step (:750).
//
// Also replaces maggy_tpu/ops/flash.py::_dq_kernel (launched by _bwd_call):
// flash attention's dQ is the one-step ring with diagonal = causal, one
// segment array for q and k, and dQ stored in the input type (Out = T).
//
// delta = rowsum(dO * O) is recomputed per q tile from the O and dO tiles, as
// the TPU kernels recompute it per tile (ring_flash.py:539); the result is
// the same as computing it once per backward.
//
// One CTA per (q tile of 64 rows, head, batch) holds its Q and dO tiles in
// shared memory and walks the visiting chunk's KV tiles, its dQ in fp32
// registers; the KV head is h / group. The step's mask is the host's: the
// diagonal (causal, aligned), a past chunk (none), with separate segment ids
// for the q and KV chunks. Each CTA owns its rows of the output, so there are
// no atomics.
//
// Bound on the H100: three 64x64xD products per tile pair (S, dP, dS K)
// against about 4 * D bytes read per row: bound by tensor-core operations.
// This first version uses mma.sync from single-buffered shared tiles.
#include "flash_common.cuh"

namespace mt {

struct RingDqArgs {
  const uint16_t* q; const uint16_t* k; const uint16_t* v; const uint16_t* o; const uint16_t* dout;
  const float* lse; const int* qsegs; const int* ksegs; void* dq;  // float or T: Out
  int H, KH, C, diagonal, first; float scale;
  Strides qs, ks, vs, os, dos, dqs;
  RowStrides st;  // lse
  long long qseg_b, kseg_b;
};

template <int D, typename T, typename Out>
__global__ void __launch_bounds__(NT) ring_dq_kernel(const RingDqArgs a) {
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
  const int* qsegs = a.qsegs ? a.qsegs + b * a.qseg_b : nullptr;
  const int* ksegs = a.ksegs ? a.ksegs + b * a.kseg_b : nullptr;

  load_tile<D>(sQ, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.C, tid);
  load_tile<D>(sdO, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.C, tid);
  load_tile<D>(sK, a.o + b * a.os.b + h * a.os.h, a.os.s, q0, a.C, tid);  // O, only for delta
  __syncthreads();
  row_dot<D, T>(sDelta, sdO, sK, tid);
  __syncthreads();

  const int lr = warp * 16 + (lane >> 2);
  const int row[2] = {q0 + lr, q0 + lr + 8};
  float lse[2], delta[2] = {sDelta[lr], sDelta[lr + 8]};
  int qseg[2] = {0, 0};
  for (int r = 0; r < 2; ++r) {
    lse[r] = row[r] < a.C ? a.lse[b * a.st.b + h * a.st.h + row[r]] : INFINITY;
    if (qsegs) qseg[r] = row[r] < a.C ? qsegs[row[r]] : -2;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int kv_end = a.diagonal ? min(a.C, q0 + BM) : a.C;
  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();  // sK held O (first pass) or the previous tile
    load_tile<D>(sK, kp, a.ks.s, n0, a.C, tid);
    load_tile<D>(sV, vp, a.vs.s, n0, a.C, tid);
    load_segs(sSeg, ksegs, n0, a.C, tid);
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
        const bool ok = col < a.C && (!a.diagonal || col <= row[r]) && (!ksegs || qseg[r] == sSeg[cl]);
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
    if (row[r] >= a.C) continue;
    Out* out = static_cast<Out*>(a.dq) + b * a.dqs.b + h * a.dqs.h + (long long)row[r] * a.dqs.s;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) put2<T>(out + dt * 8 + tig * 2, acc[dt][2 * r], acc[dt][2 * r + 1], a.first);
  }
}

template <int D, typename T, typename Out>
int launch(const RingDqArgs& a, int B, cudaStream_t stream) {
  const int smem = 4 * tile_elems(D) * 2 + BM * 4 + BN * 4;
  cudaFuncSetAttribute(ring_dq_kernel<D, T, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((a.C + BM - 1) / BM, a.H, B);
  ring_dq_kernel<D, T, Out><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 q/k/v/o/dO and fp32 LSE. dQ is an fp32 accumulator with `accumulate`
// (stored on the first step, added to after), else bf16 and stored. Returns
// cudaGetLastError() after the launch, or -1 for a head_dim this kernel does
// not take.
extern "C" int mt_ring_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, const void* qsegs, const void* ksegs, void* dq,
    int B, int H, int KH, int C, int D, int diagonal, int first, int accumulate, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long st_sb, long long st_sh, long long qseg_sb, long long kseg_sb,
    void* stream) {
  mt::RingDqArgs a{};
  a.q = static_cast<const uint16_t*>(q); a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v); a.o = static_cast<const uint16_t*>(o);
  a.dout = static_cast<const uint16_t*>(dout); a.lse = static_cast<const float*>(lse);
  a.qsegs = static_cast<const int*>(qsegs); a.ksegs = static_cast<const int*>(ksegs);
  a.dq = dq;
  a.H = H; a.KH = KH; a.C = C; a.diagonal = diagonal; a.first = first; a.scale = scale;
  a.qs = {q_sb, q_ss, q_sh}; a.ks = {k_sb, k_ss, k_sh}; a.vs = {v_sb, v_ss, v_sh};
  a.os = {o_sb, o_ss, o_sh}; a.dos = {do_sb, do_ss, do_sh}; a.dqs = {dq_sb, dq_ss, dq_sh};
  a.st = {st_sb, st_sh}; a.qseg_b = qseg_sb; a.kseg_b = kseg_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (D == 128) return accumulate ? mt::launch<128, bf16, float>(a, B, st) : mt::launch<128, bf16, uint16_t>(a, B, st);
  if (D == 64) return accumulate ? mt::launch<64, bf16, float>(a, B, st) : mt::launch<64, bf16, uint16_t>(a, B, st);
  return -1;
}
