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
// Bound on the H100: three 64 x 64 x D products per (q tile, KV tile) pair
// (S = Q K^T, dP = dO V^T, dS K), 6 * D flops per visible (q, k) pair,
// against about 4 * D bytes read per q row (Q, dO, O, dQ) and 4 * D per KV
// row: far above the ~295 flop/byte ridge, so bound by tensor-core
// operations (989 TFLOP/s bf16 dense). The design is the forward's
// (ring_fwd.cu) with one more product:
// - one CTA per (q tile of 128 rows, head, batch); the KV head is h / group.
//   A producer warp brings the Q and dO tiles once by TMA, then streams K
//   and V tiles of 64 rows through a ring of shared-memory stages under
//   full/empty mbarriers (3 stages at D = 128: Q 32 KB + dO 32 KB +
//   3 x 32 KB; 4 at D = 64), and the KV tile's segment ids by plain loads;
//   TMA zero-fills rows past C;
// - two consumer warpgroups each own 64 of the q rows. Once per CTA each
//   computes delta = rowsum(dO * O) in fp32 for its rows (O is read once,
//   16 bytes a load, and for nothing else), so delta and the LSE of a
//   thread's two accumulator rows stay in registers; rows past C take
//   LSE = +inf, so P = 0 there;
// - per KV tile: S = Q K^T and dP = dO V^T by wgmma m64n64k16 from shared
//   memory (both K-major), P = 2^(S scale log2 e - LSE log2 e), the mask
//   only on tiles that cross the diagonal or the ragged edge or carry
//   segment ids, dS = P (dP - delta) scale rounded to bf16 in registers as
//   the TPU kernel rounds it, then dQ += dS K with dS as the register A
//   operand and K read MN-major (transpose bit), as the forward's O += P V;
// - 64-row KV tiles keep a thread's accumulators at dQ (D / 2) + S (32) +
//   dP (32) registers: with 128-row tiles S and dP alone would take 128,
//   the layout whose spills and serialised wgmma the dK/dV kernel showed;
//   setmaxnreg moves registers from the producer warpgroup (40 a thread:
//   with 24 the D = 128 producer spilled) to the consumers (232);
// - on the diagonal the q tiles run heaviest first (the grid's slowest axis
//   walks them from the last), so the short ones fill in at the end;
// - each CTA owns its rows of dQ: no atomics.
#include "hopper.cuh"

namespace mt {

struct RingDqArgs {
  const uint16_t* o; const uint16_t* dout; const float* lse; const int* qsegs; const int* ksegs;
  void* dq;  // float or T: Out
  int H, KH, C, diagonal, first; float scale;
  Strides os, dos, dqs;
  RowStrides st;  // lse
  long long qseg_b, kseg_b;
};

constexpr int DQ_BM = 128;       // q rows of a CTA: 64 for each consumer warpgroup
constexpr int DQ_BN = 64;        // rows of a streamed K or V tile
constexpr int DQ_THREADS = 384;  // two consumer warpgroups, then a producer warpgroup

template <int D>
struct DqSmem {  // byte offsets from a 1024-aligned base
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int Q_BYTES = DQ_BM * D * 2;  // Q or dO
  static constexpr int KV_BYTES = DQ_BN * D * 2;  // one K or V tile
  static constexpr int Q = 0, DO = Q_BYTES;
  static constexpr int KV = 2 * Q_BYTES;  // stage s: K at KV + 2s KV_BYTES, V after it
  static constexpr int SEG = KV + STAGES * 2 * KV_BYTES;  // the KV tile's segment ids, per stage
  static constexpr int BAR = SEG + STAGES * DQ_BN * 4;     // Q/dO's barrier, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
};

template <int D, typename T, typename Out>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    ring_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const RingDqArgs a) {
  using namespace hopper;
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + L::STAGES;
  int* sseg = reinterpret_cast<int*>(smem + L::SEG);

  // heaviest diagonal tiles first: they start while the light ones fill in
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_BM;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (a.H / a.KH);
  const int kv_end = a.diagonal ? min(a.C, q0 + DQ_BM) : a.C;
  const int n_tiles = (kv_end + DQ_BN - 1) / DQ_BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one warp keeps the stages filled; the rest of its warpgroup ends
    reg_dealloc<40>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x - 256;
      const int* ksegs = a.ksegs ? a.ksegs + b * a.kseg_b : nullptr;
      if (lane == 0) {
        mbar_arrive_tx(bar_q, 2 * L::Q_BYTES);
        tma_rows<D, DQ_BM>(smem_u32(smem + L::Q), &tq, bar_q, q0, h, b);
        tma_rows<D, DQ_BM>(smem_u32(smem + L::DO), &tdo, bar_q, q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::STAGES;
        mbar_wait(&empty[s], ((i / L::STAGES) & 1) ^ 1);
        if (ksegs) {
          for (int c = lane; c < DQ_BN; c += 32) {
            const int col = i * DQ_BN + c;
            sseg[s * DQ_BN + c] = col < a.C ? ksegs[col] : -1;
          }
        }
        __syncwarp();  // the ids are stored before lane 0's arrival releases them
        if (lane == 0) {
          const uint32_t kv = smem_u32(smem + L::KV + s * 2 * L::KV_BYTES);
          mbar_arrive_tx(&full[s], 2 * L::KV_BYTES);
          tma_rows<D, DQ_BN>(kv, &tk, &full[s], i * DQ_BN, kh, b);
          tma_rows<D, DQ_BN>(kv + L::KV_BYTES, &tv, &full[s], i * DQ_BN, kh, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows q0 + 64 cw .. q0 + 64 cw + 63
    reg_alloc<232>();
    const int cw = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31, tig = lane & 3;
    const int r_lo = q0 + 64 * cw;
    const int row[2] = {r_lo + warp * 16 + (lane >> 2), r_lo + warp * 16 + (lane >> 2) + 8};
    int qseg[2] = {0, 0};
    if (a.qsegs) {
      const int* qsegs = a.qsegs + b * a.qseg_b;
      for (int r = 0; r < 2; ++r) qseg[r] = row[r] < a.C ? qsegs[row[r]] : -2;
    }

    // delta = rowsum(dO * O) of this thread's two rows: the quad splits each
    // row into 16-byte chunks 4j + tig and sums across its four threads.
    // The LSE is kept premultiplied by log2 e; +inf past C makes P = 0.
    float delta[2] = {0.f, 0.f}, lse2[2] = {INFINITY, INFINITY};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] < a.C) {
        const uint16_t* po = a.o + b * a.os.b + h * a.os.h + (long long)row[r] * a.os.s;
        const uint16_t* pd = a.dout + b * a.dos.b + h * a.dos.h + (long long)row[r] * a.dos.s;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {
          const uint4 vo = *reinterpret_cast<const uint4*>(po + (4 * j + tig) * 8);
          const uint4 vd = *reinterpret_cast<const uint4*>(pd + (4 * j + tig) * 8);
          const uint16_t* xo = reinterpret_cast<const uint16_t*>(&vo);
          const uint16_t* xd = reinterpret_cast<const uint16_t*>(&vd);
#pragma unroll
          for (int e = 0; e < 8; ++e) delta[r] = fmaf(to_f<T>(xo[e]), to_f<T>(xd[e]), delta[r]);
        }
        lse2[r] = a.lse[b * a.st.b + h * a.st.h + row[r]] * LOG2E;
      }
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    const float c1 = a.scale * LOG2E;  // exp(x * scale - lse) = 2^(x * c1 - lse log2 e)
    // this warpgroup's rows of each panel of Q and dO
    const uint32_t sq = smem_u32(smem + L::Q) + cw * 64 * 128, sdo = smem_u32(smem + L::DO) + cw * 64 * 128;
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % L::STAGES, n0 = i * DQ_BN;
      const uint32_t sk = opaque(smem_u32(smem + L::KV + s * 2 * L::KV_BYTES)), sv = sk + L::KV_BYTES;
      const uint32_t q_t = opaque(sq), do_t = opaque(sdo);
      mbar_wait(&full[s], (i / L::STAGES) & 1);

      // S = Q K^T (raw scores) and dP = dO V^T
      float sc[DQ_BN / 2], dp[DQ_BN / 2];
      wg_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        Wgmma<DQ_BN>::ss<0>(sc, desc_k<DQ_BM>(q_t, k), desc_k<DQ_BN>(sk, k), k > 0);
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        Wgmma<DQ_BN>::ss<0>(dp, desc_k<DQ_BM>(do_t, k), desc_k<DQ_BN>(sv, k), k > 0);
      wg_commit();
      wg_wait<0>();
      touch<DQ_BN / 2>(sc);
      touch<DQ_BN / 2>(dp);

      // P, masked only where the tile needs it, and dS = P (dP - delta)
      // scale, in place of the scores
      const bool masked = a.ksegs != nullptr || n0 + DQ_BN > a.C || (a.diagonal && n0 + DQ_BN - 1 > r_lo);
      const int* seg = sseg + s * DQ_BN;
#pragma unroll
      for (int j = 0; j < DQ_BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, cl = j * 8 + tig * 2 + (e & 1), col = n0 + cl;
          float p = exp2_approx(fmaf(sc[4 * j + e], c1, -lse2[r]));
          if (masked && !(col < a.C && (!a.diagonal || col <= row[r]) && (!a.ksegs || qseg[r] == seg[cl])))
            p = 0.f;
          sc[4 * j + e] = p * (dp[4 * j + e] - delta[r]) * a.scale;
        }
      }

      // dQ += dS K, dS rounded to the input type as the TPU kernel does
      uint32_t da[DQ_BN / 16][4];
#pragma unroll
      for (int k = 0; k < DQ_BN / 16; ++k) pack_a<T>(da[k], sc, k);
      touch<D / 2>(dq);
      wg_fence();
#pragma unroll
      for (int k = 0; k < DQ_BN / 16; ++k) Wgmma<D>::template rs<1>(dq, da[k], desc_mn<DQ_BN>(sk, k), 1);
      wg_commit();
      wg_wait<0>();
      touch<D / 2>(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.C) continue;
      Out* out = static_cast<Out*>(a.dq) + b * a.dqs.b + h * a.dqs.h + (long long)row[r] * a.dqs.s;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) put2<T>(out + j * 8 + tig * 2, dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1], a.first);
    }
  }
}

template <int D, typename T, typename Out>
int launch(const void* q, const void* k, const void* v, const Strides& qs, const Strides& ks, const Strides& vs,
           const RingDqArgs& a, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = encode_rows(&tq, q, D, a.C, a.H, B, qs.s, qs.h, qs.b, DQ_BM);
  if (rc == 0) rc = encode_rows(&tdo, a.dout, D, a.C, a.H, B, a.dos.s, a.dos.h, a.dos.b, DQ_BM);
  if (rc == 0) rc = encode_rows(&tk, k, D, a.C, a.KH, B, ks.s, ks.h, ks.b, DQ_BN);
  if (rc == 0) rc = encode_rows(&tv, v, D, a.C, a.KH, B, vs.s, vs.h, vs.b, DQ_BN);
  if (rc != 0) return rc;
  const int smem = DqSmem<D>::BYTES + 1024;  // and room to align the base to 1024
  cudaFuncSetAttribute(ring_dq_kernel<D, T, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(a.H, B, (a.C + DQ_BM - 1) / DQ_BM);
  ring_dq_kernel<D, T, Out><<<grid, DQ_THREADS, smem, stream>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 q/k/v/o/dO and fp32 LSE. dQ is an fp32 accumulator with `accumulate`
// (stored on the first step, added to after), else bf16 and stored. Returns
// cudaGetLastError() after the launch, -1 for a head_dim this kernel does
// not take, -2 or -3 if a tensor map cannot be made (mt::encode_rows).
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
  a.o = static_cast<const uint16_t*>(o); a.dout = static_cast<const uint16_t*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.qsegs = static_cast<const int*>(qsegs); a.ksegs = static_cast<const int*>(ksegs);
  a.dq = dq;
  a.H = H; a.KH = KH; a.C = C; a.diagonal = diagonal; a.first = first; a.scale = scale;
  a.os = {o_sb, o_ss, o_sh}; a.dos = {do_sb, do_ss, do_sh}; a.dqs = {dq_sb, dq_ss, dq_sh};
  a.st = {st_sb, st_sh}; a.qseg_b = qseg_sb; a.kseg_b = kseg_sb;
  const mt::Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (D == 128) {
    return accumulate ? mt::launch<128, bf16, float>(q, k, v, qs, ks, vs, a, B, st)
                      : mt::launch<128, bf16, uint16_t>(q, k, v, qs, ks, vs, a, B, st);
  }
  if (D == 64) {
    return accumulate ? mt::launch<64, bf16, float>(q, k, v, qs, ks, vs, a, B, st)
                      : mt::launch<64, bf16, uint16_t>(q, k, v, qs, ks, vs, a, B, st);
  }
  return -1;
}
