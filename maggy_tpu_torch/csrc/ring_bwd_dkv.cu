// Attention backward, dK and dV, for Hopper: one ring step, and flash
// attention as the one-step ring.
//
// Replaces the dK/dV half of maggy_tpu/ops/ring_flash.py::_ring_bwd_kernel
// (launched by _ring_bwd_local): at one ring step, the visiting KV chunk's
// dV += P^T dO and dK += dS^T Q from the local q chunk, with P recomputed from
// the forward's LSE, delta = rowsum(dO * O) (the TPU kernel recomputed it per
// tile, :539) and the GQA group summed. The TPU kernel folded these into fp32
// (dk, dv) accumulators that rotate with the chunk (:549-558, :635-650); this
// kernel (Out = float) reads, adds and writes the same fp32 accumulators of
// the visiting chunk in device memory, storing them on the chunk's first
// step instead. The ring moves them; the caller casts them to bf16 once,
// after the last rotation (:750-752).
//
// Also replaces maggy_tpu/ops/flash.py::_dkv_kernel (launched by _bwd_call)
// and the GQA group sum in _flash_core's core_bwd: flash attention's dK/dV
// is the one-step ring with diagonal = causal, one segment array for q and
// k, and dK/dV stored in the input type (Out = T). The TPU kernel wrote
// per-q-head gradients [B*H, S, D] and the caller summed each group; here
// the group sum happens in registers, with no [B, S, H, D] intermediate.
//
// Bound on the H100: four 64 x 64 x D products per (KV tile, q tile) pair,
// 8 * D flops per visible (q, k) pair, against about 6 * D bytes streamed
// per q row: bound by tensor-core operations (989 TFLOP/s bf16 dense). The
// design:
// - delta = rowsum(dO * O) is computed once per q row by a prepass kernel
//   (dkv_delta_kernel, same launch) into an fp32 [B, H, C] scratch, so the
//   main loop never reads O;
// - one CTA per (KV tile of 64 rows, KV head, batch) keeps K and V in shared
//   memory and loops over the group's q heads and the q tiles at or below
//   the diagonal (all of them on a past step); each CTA owns its rows, so
//   there are no atomics;
// - one producer warp streams, per (q head, q tile of 64 rows), Q and dO by
//   TMA and the LSE, delta and segment-id rows by plain loads, through a ring
//   of two shared-memory stages under full/empty mbarriers;
// - two consumer warpgroups split each pair's work: warpgroup w computes
//   S^T = K Q^T and dP^T = V dO^T for q columns 32w..32w+31 (wgmma
//   m64n32k16, both operands K-major in shared memory), P^T and
//   dS^T = P^T (dP^T - delta) scale in registers, and stores them in bf16
//   (rounded as the TPU kernel rounds them) to a 128-byte-swizzled tile in
//   shared memory; after a barrier of the two, warpgroup 0 adds
//   dV += P^T dO and warpgroup 1 dK += dS^T Q for all 64 KV rows (m64nDk16,
//   A from that tile, dO and Q read MN-major with the transpose bit). The
//   P^T/dS^T tiles are double-buffered, so one barrier a pair suffices;
// - so a thread holds one D/2-register accumulator (dV or dK) and 32 for
//   its S^T and dP^T columns. A warpgroup holding dK, dV, S^T and dP^T
//   together (192 accumulator registers) spilled and had its wgmma
//   serialised by ptxas even with setmaxnreg's 240; this split needs about
//   100 and computes no product twice. setmaxnreg still moves registers
//   from the producer warpgroup (56 a thread) to the consumers (224);
// - at the ring's shapes (C = 2048, Kh = 8, B = 1) that is 256 CTAs, one an
//   SM (384 threads), about two waves on 132 SMs; on the diagonal the first
//   KV tiles, which see the most q tiles, start first;
// - only the diagonal's tile pair and packed sequences take a per-element
//   mask; rows past C need none (their LSE is +inf, so P = 0).
#include "hopper.cuh"

namespace mt {

struct RingDkvArgs {
  const float* lse; const float* delta; const int* qsegs; const int* ksegs; void* dk; void* dv;  // float or T: Out
  int H, KH, C, diagonal, first; float scale;
  Strides dks, dvs;
  RowStrides st;  // lse
  long long qseg_b, kseg_b;
};

constexpr int DKV_BN = 64;         // KV rows of a CTA
constexpr int DKV_BM = 64;         // rows of a streamed q tile: 32 for each consumer warpgroup
constexpr int DKV_THREADS = 384;  // two consumer warpgroups, then a producer warpgroup
constexpr int DKV_STAGES = 2;

template <int D>
struct DkvSmem {  // byte offsets from a 1024-aligned base
  static constexpr int KV_TILE = DKV_BN * D * 2, TILE = DKV_BM * D * 2;
  static constexpr int K = 0, V = KV_TILE;
  static constexpr int QDO = 2 * KV_TILE;  // stage s: Q at QDO + 2s TILE, dO after it
  static constexpr int ROWS = QDO + DKV_STAGES * 2 * TILE;  // stage s: lse, delta, seg (64 each)
  static constexpr int ROW_BYTES = DKV_STAGES * 3 * DKV_BM * 4;
  // P^T, dS^T tiles of pair i at PDS + 2 (i % 2) PDS_TILE, 1024-aligned past the rows
  static constexpr int PDS = (ROWS + ROW_BYTES + 1023) / 1024 * 1024;
  static constexpr int PDS_TILE = DKV_BN * DKV_BM * 2;
  static constexpr int BAR = PDS + 4 * PDS_TILE;  // K/V's barrier, full[], empty[]
  static constexpr int BYTES = BAR + (1 + 2 * DKV_STAGES) * 8;
};

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32, one warp a row.
template <int D, typename T>
__global__ void __launch_bounds__(256) dkv_delta_kernel(const uint16_t* o, const uint16_t* dout, float* delta,
                                                        int H, int C, long long rows, Strides os, Strides dos) {
  constexpr int E = D / 32;  // elements a lane
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;
  const int h = static_cast<int>(w % H), i = static_cast<int>((w / H) % C);
  const long long b = w / (static_cast<long long>(H) * C);
  const uint16_t* po = o + b * os.b + i * os.s + h * os.h + lane * E;
  const uint16_t* pd = dout + b * dos.b + i * dos.s + h * dos.h + lane * E;
  uint16_t xo[E], xd[E];
  if constexpr (E == 4) {
    *reinterpret_cast<uint2*>(xo) = *reinterpret_cast<const uint2*>(po);
    *reinterpret_cast<uint2*>(xd) = *reinterpret_cast<const uint2*>(pd);
  } else {
    *reinterpret_cast<uint32_t*>(xo) = *reinterpret_cast<const uint32_t*>(po);
    *reinterpret_cast<uint32_t*>(xd) = *reinterpret_cast<const uint32_t*>(pd);
  }
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc += to_f<T>(xo[e]) * to_f<T>(xd[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(b * H + h) * C + i] = acc;
}

template <int D, typename T, typename Out>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    ring_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const RingDkvArgs a) {
  using namespace hopper;
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + DKV_STAGES;
  float* srows = reinterpret_cast<float*>(smem + L::ROWS);  // stage s at srows + 3 * 64 * s

  // the first KV tiles see the most q tiles on the diagonal: the grid's
  // slowest axis starts them first
  const int n0 = blockIdx.z * DKV_BN;
  const int kh = blockIdx.x, b = blockIdx.y, group = a.H / a.KH;
  // on the diagonal a KV tile receives gradient only from q tiles at or after it
  const int q_begin = a.diagonal ? (n0 / DKV_BM) * DKV_BM : 0;
  const int n_qt = (a.C - q_begin + DKV_BM - 1) / DKV_BM;
  const int n_pairs = group * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one warp keeps the stages filled; the rest of its warpgroup ends
    reg_dealloc<56>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x - 256;
      const int* qsegs = a.qsegs ? a.qsegs + b * a.qseg_b : nullptr;
      if (lane == 0) {
        mbar_arrive_tx(bar_kv, 2 * L::KV_TILE);
        tma_rows<D, DKV_BN>(smem_u32(smem + L::K), &tk, bar_kv, n0, kh, b);
        tma_rows<D, DKV_BN>(smem_u32(smem + L::V), &tv, bar_kv, n0, kh, b);
      }
      for (int i = 0; i < n_pairs; ++i) {
        const int s = i % DKV_STAGES, h = kh * group + i / n_qt, q0 = q_begin + (i % n_qt) * DKV_BM;
        mbar_wait(&empty[s], ((i / DKV_STAGES) & 1) ^ 1);
        float* rows = srows + s * 3 * DKV_BM;
        const float* lse = a.lse + b * a.st.b + h * a.st.h;
        const float* delta = a.delta + (static_cast<long long>(b) * a.H + h) * a.C;
        for (int c = lane; c < DKV_BM; c += 32) {
          const int r = q0 + c;
          const bool in = r < a.C;
          rows[c] = in ? lse[r] : INFINITY;  // P = 0 past the edge
          rows[DKV_BM + c] = in ? delta[r] : 0.f;
          if (qsegs) reinterpret_cast<int*>(rows)[2 * DKV_BM + c] = in ? qsegs[r] : -1;
        }
        __syncwarp();  // the rows are stored before lane 0's arrival releases them
        if (lane == 0) {
          const uint32_t qdo = smem_u32(smem + L::QDO + s * 2 * L::TILE);
          mbar_arrive_tx(&full[s], 2 * L::TILE);
          tma_rows<D, DKV_BM>(qdo, &tq, &full[s], q0, h, b);
          tma_rows<D, DKV_BM>(qdo + L::TILE, &tdo, &full[s], q0, h, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes q columns 32 cw..32 cw + 31 of S^T
    // and dP^T, then dV (cw = 0) or dK (cw = 1) for all of the CTA's KV rows
    reg_alloc<224>();
    const int cw = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31, tig = lane & 3, c0 = 32 * cw;
    const int krow[2] = {n0 + warp * 16 + (lane >> 2), n0 + warp * 16 + (lane >> 2) + 8};
    int kseg[2] = {0, 0};
    if (a.ksegs) {
      const int* ksegs = a.ksegs + b * a.kseg_b;
      for (int r = 0; r < 2; ++r) kseg[r] = krow[r] < a.C ? ksegs[krow[r]] : -2;
    }
    float acc[D / 2];  // dV or dK
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const float c1 = a.scale * LOG2E;  // exp(x * scale - lse) = 2^(x * c1 - lse log2 e)
    const uint32_t sk = smem_u32(smem + L::K), sv = smem_u32(smem + L::V);
    mbar_wait(bar_kv, 0);

    for (int i = 0; i < n_pairs; ++i) {
      const int s = i % DKV_STAGES, q0 = q_begin + (i % n_qt) * DKV_BM;
      const uint32_t sq = opaque(smem_u32(smem + L::QDO + s * 2 * L::TILE)), sdo = sq + L::TILE;
      const uint32_t k_t = opaque(sk), v_t = opaque(sv);
      const float* rows = srows + s * 3 * DKV_BM;
      const int* seg = reinterpret_cast<const int*>(rows) + 2 * DKV_BM;
      unsigned char* pds = smem + L::PDS + (i % 2) * 2 * L::PDS_TILE;  // P^T, then dS^T
      mbar_wait(&full[s], (i / DKV_STAGES) & 1);

      // this warpgroup's columns of S^T = K Q^T and dP^T = V dO^T
      float pt[16], dpt[16];
      wg_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        Wgmma<32>::ss<0>(pt, desc_k<DKV_BN>(k_t, k), desc_k<DKV_BM>(sq + c0 * 128, k), k > 0);
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        Wgmma<32>::ss<0>(dpt, desc_k<DKV_BN>(v_t, k), desc_k<DKV_BM>(sdo + c0 * 128, k), k > 0);
      wg_commit();
      wg_wait<0>();
      touch<16>(pt);
      touch<16>(dpt);

      // P^T = exp(S^T * scale - lse[q]), masked where the pair needs it, and
      // dS^T = P^T (dP^T - delta[q]) scale; both stored in bf16 at
      // (KV row, q column) of their swizzled tiles
      const bool masked = a.qsegs != nullptr || (a.diagonal && q0 < n0 + DKV_BN - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * r + e, cl = c0 + j * 8 + tig * 2 + e;
            p[e] = exp2_approx(fmaf(pt[x], c1, -rows[cl] * LOG2E));
            if (masked && !((!a.diagonal || krow[r] <= q0 + cl) && (!a.qsegs || kseg[r] == seg[cl]))) p[e] = 0.f;
            ds[e] = p[e] * (dpt[x] - rows[DKV_BM + cl]) * a.scale;
          }
          const int row = krow[r] - n0, chunk = (c0 / 8 + j) ^ (row & 7);
          const int off = row * 128 + chunk * 16 + tig * 4;
          *reinterpret_cast<uint32_t*>(pds + off) = pack<T>(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(pds + L::PDS_TILE + off) = pack<T>(ds[0], ds[1]);
        }
      }
      fence_async_smem();
      named_sync(1, 256);  // both halves of P^T and dS^T are in place

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
      const uint32_t a_tile = smem_u32(pds) + cw * L::PDS_TILE, b_tile = cw ? sq : sdo;
      touch<D / 2>(acc);
      wg_fence();
#pragma unroll
      for (int k = 0; k < DKV_BM / 16; ++k)
        Wgmma<D>::template ss<1>(acc, desc_k<DKV_BN>(a_tile, k), desc_mn<DKV_BM>(b_tile, k), 1);
      wg_commit();
      wg_wait<0>();
      touch<D / 2>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

    Out* out = static_cast<Out*>(cw ? a.dk : a.dv);
    const Strides os = cw ? a.dks : a.dvs;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (krow[r] >= a.C) continue;
      Out* p = out + b * os.b + kh * os.h + (long long)krow[r] * os.s;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) put2<T>(p + j * 8 + tig * 2, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1], a.first);
    }
  }
}

template <int D, typename T, typename Out>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, float* delta,
           const Strides& qs, const Strides& ks, const Strides& vs, const Strides& os, const Strides& dos,
           const RingDkvArgs& a, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = encode_rows(&tq, q, D, a.C, a.H, B, qs.s, qs.h, qs.b, DKV_BM);
  if (rc == 0) rc = encode_rows(&tk, k, D, a.C, a.KH, B, ks.s, ks.h, ks.b, DKV_BN);
  if (rc == 0) rc = encode_rows(&tv, v, D, a.C, a.KH, B, vs.s, vs.h, vs.b, DKV_BN);
  if (rc == 0) rc = encode_rows(&tdo, dout, D, a.C, a.H, B, dos.s, dos.h, dos.b, DKV_BM);
  if (rc != 0) return rc;
  const long long rows = static_cast<long long>(B) * a.C * a.H;
  dkv_delta_kernel<D, T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const uint16_t*>(o), static_cast<const uint16_t*>(dout), delta, a.H, a.C, rows, os, dos);
  const int smem = DkvSmem<D>::BYTES + 1024;  // and room to align the base to 1024
  cudaFuncSetAttribute(ring_dkv_kernel<D, T, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(a.KH, B, (a.C + DKV_BN - 1) / DKV_BN);
  ring_dkv_kernel<D, T, Out><<<grid, DKV_THREADS, smem, stream>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 q/k/v/o/dO and fp32 LSE; `delta` is an fp32 [B, H, C] scratch the
// kernel fills. dK/dV are fp32 accumulators with `accumulate` (stored on the
// chunk's first step, added to after), else bf16 and stored. Returns
// cudaGetLastError() after the launches, -1 for a head_dim this kernel does
// not take, -2 or -3 if a tensor map cannot be made (mt::encode_rows).
extern "C" int mt_ring_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, const void* qsegs, const void* ksegs, void* dk, void* dv,
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
  a.lse = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.qsegs = static_cast<const int*>(qsegs); a.ksegs = static_cast<const int*>(ksegs);
  a.dk = dk; a.dv = dv;
  a.H = H; a.KH = KH; a.C = C; a.diagonal = diagonal; a.first = first; a.scale = scale;
  a.dks = {dk_sb, dk_ss, dk_sh}; a.dvs = {dv_sb, dv_ss, dv_sh};
  a.st = {st_sb, st_sh}; a.qseg_b = qseg_sb; a.kseg_b = kseg_sb;
  const mt::Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const mt::Strides os{o_sb, o_ss, o_sh}, dos{do_sb, do_ss, do_sh};
  float* d = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (D == 128) {
    return accumulate ? mt::launch<128, bf16, float>(q, k, v, o, dout, d, qs, ks, vs, os, dos, a, B, st)
                      : mt::launch<128, bf16, uint16_t>(q, k, v, o, dout, d, qs, ks, vs, os, dos, a, B, st);
  }
  if (D == 64) {
    return accumulate ? mt::launch<64, bf16, float>(q, k, v, o, dout, d, qs, ks, vs, os, dos, a, B, st)
                      : mt::launch<64, bf16, uint16_t>(q, k, v, o, dout, d, qs, ks, vs, os, dos, a, B, st);
  }
  return -1;
}
