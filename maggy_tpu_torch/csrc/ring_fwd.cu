// Attention forward for Hopper: one ring step, and flash attention as the
// one-step ring.
//
// Replaces the compute of maggy_tpu/ops/ring_flash.py::_ring_kernel (launched
// by _ring_flash_local): at one ring step, the online-softmax update of the
// local q chunk [B, C, H, D] against the visiting KV chunk [B, C, Kh, D], with
// fp32 (acc, m, l) carried in device memory from step to step, as the TPU
// kernel carried them in HBM (:172-226). On the rank's last computed step
// (finalize) it writes O in the input type and LSE = m + log l (+inf where
// l = 0, :818) instead of the state.
//
// Also replaces maggy_tpu/ops/flash.py::_fwd_kernel (launched by _fwd_call):
// flash attention over a whole sequence is this kernel with first and
// finalize both set, diagonal = causal and one segment array for q and k,
// so the state never touches device memory. The TPU walked the KV blocks as
// a sequential grid axis with (m, l, acc) in VMEM scratch; here one CTA per
// (q tile of 128 rows, head, batch) walks the KV tiles in a loop with m, l
// and acc in registers, and the CTAs run in parallel over the 132 SMs. GQA
// lives in the addressing (KV head = h / group), so repeated K/V never exist.
//
// What differs from the TPU ring kernel: it also rotated KV with an in-kernel
// RDMA; here the rotation is the caller's (NCCL on a side stream, or index
// arithmetic in one process) and this kernel is one launch per step. Chunks
// are equal, so the mask is the host's choice of three cases: the diagonal
// (causal, q and k aligned), a past chunk (no mask), a future chunk (no
// launch). The q and KV chunks carry separate segment ids, so packed
// segments may cross chunk boundaries. Each CTA loads its state from device
// memory (unless first) and writes it back: each CTA owns its rows, so no
// atomics. m starts at -1e30, not -inf, so a row that sees no key in a step
// gives no inf - inf.
//
// Bound on the H100: a 2048 x 2048 step at D = 128 does 4 * D flops per
// visible (q, k) pair against 2 * D bytes of q, k and v per row, far above
// the ~295 flop/byte ridge: bound by tensor-core operations (989 TFLOP/s
// bf16 dense). So the design keeps the tensor cores fed:
// - one producer warp issues TMA copies of K and V tiles (128 rows) into a
//   ring of shared-memory stages (2 at D = 128: Q 32 KB + 2 x 64 KB; 4 at
//   D = 64), each stage a full/empty mbarrier pair, so copies run ahead of
//   the math; TMA zero-fills rows past C;
// - two consumer warpgroups each own 64 of the CTA's 128 q rows: S = Q K^T
//   by wgmma m64n128k16 from shared memory (both K-major), the online softmax
//   in registers (quad shuffles for the row max), P rounded to bf16 in
//   registers as the A operand of O += P V, V read MN-major (transpose bit);
// - setmaxnreg moves registers from the producer warpgroup (24 a thread) to
//   the consumers (240): S, O and P stay in registers;
// - only tiles that cross the diagonal or the ragged edge, or carry segment
//   ids, evaluate the mask per element; a past step's full tiles take none;
// - on the diagonal the q tiles run heaviest first (the grid's slowest axis
//   walks them from the last), so the short ones fill in at the end.
#include "hopper.cuh"

namespace mt {

struct RingFwdArgs {
  const int* qsegs; const int* ksegs;
  float* acc; float* m; float* l; uint16_t* o; float* lse;
  int H, KH, C, diagonal, first, finalize; float scale;
  Strides accs, os;
  RowStrides st;  // m, l and lse
  long long qseg_b, kseg_b;
};

constexpr int FWD_BM = 128;       // q rows of a CTA: 64 for each consumer warpgroup
constexpr int FWD_BN = 128;       // rows of a streamed K or V tile
constexpr int FWD_THREADS = 384;  // two consumer warpgroups, then a producer warpgroup

template <int D>
struct FwdSmem {  // byte offsets from a 1024-aligned base
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int Q_BYTES = FWD_BM * D * 2;
  static constexpr int KV_BYTES = FWD_BN * D * 2;  // one K or V tile
  static constexpr int Q = 0;
  static constexpr int KV = Q + Q_BYTES;  // stage s: K at KV + 2s KV_BYTES, V after it
  static constexpr int SEG = KV + STAGES * 2 * KV_BYTES;  // the KV tile's segment ids, per stage
  static constexpr int BAR = SEG + STAGES * FWD_BN * 4;    // Q's barrier, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
};

template <int D, typename T>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    ring_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const RingFwdArgs a) {
  using namespace hopper;
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + L::STAGES;
  int* sseg = reinterpret_cast<int*>(smem + L::SEG);

  // heaviest diagonal tiles first: they start while the light ones fill in
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FWD_BM;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / (a.H / a.KH);
  const int kv_end = a.diagonal ? min(a.C, q0 + FWD_BM) : a.C;
  const int n_tiles = (kv_end + FWD_BN - 1) / FWD_BN;

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
    reg_dealloc<24>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x - 256;
      const int* ksegs = a.ksegs ? a.ksegs + b * a.kseg_b : nullptr;
      if (lane == 0) {
        mbar_arrive_tx(bar_q, L::Q_BYTES);
        tma_rows<D, FWD_BM>(smem_u32(smem + L::Q), &tq, bar_q, q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % L::STAGES;
        mbar_wait(&empty[s], ((i / L::STAGES) & 1) ^ 1);
        if (ksegs) {
          for (int c = lane; c < FWD_BN; c += 32) {
            const int col = i * FWD_BN + c;
            sseg[s * FWD_BN + c] = col < a.C ? ksegs[col] : -1;
          }
        }
        __syncwarp();  // the ids are stored before lane 0's arrival releases them
        if (lane == 0) {
          const uint32_t kv = smem_u32(smem + L::KV + s * 2 * L::KV_BYTES);
          mbar_arrive_tx(&full[s], 2 * L::KV_BYTES);
          tma_rows<D, FWD_BN>(kv, &tk, &full[s], i * FWD_BN, kh, b);
          tma_rows<D, FWD_BN>(kv + L::KV_BYTES, &tv, &full[s], i * FWD_BN, kh, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows q0 + 64 cw .. q0 + 64 cw + 63
    reg_alloc<240>();
    const int cw = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31, tig = lane & 3;
    const int r_lo = q0 + 64 * cw;
    const int row[2] = {r_lo + warp * 16 + (lane >> 2), r_lo + warp * 16 + (lane >> 2) + 8};
    const long long st0 = b * a.st.b + h * a.st.h;
    int qseg[2] = {0, 0};
    if (a.qsegs) {
      const int* qsegs = a.qsegs + b * a.qseg_b;
      for (int r = 0; r < 2; ++r) qseg[r] = row[r] < a.C ? qsegs[row[r]] : -2;
    }

    // the running state: fresh on the first step, else this tile's rows from
    // device memory. l is a per-thread partial sum, so the quad's first thread
    // takes the stored total and the others start at 0.
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    if (!a.first) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= a.C) continue;
        m[r] = a.m[st0 + row[r]];
        if (tig == 0) l[r] = a.l[st0 + row[r]];
        const float* ap = a.acc + b * a.accs.b + h * a.accs.h + (long long)row[r] * a.accs.s;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(ap + j * 8 + tig * 2);
          o[4 * j + 2 * r] = x.x;
          o[4 * j + 2 * r + 1] = x.y;
        }
      }
    }

    const float c1 = a.scale * LOG2E;  // exp(x * scale - m) = 2^(x * c1 - m log2 e)
    const uint32_t sq = smem_u32(smem + L::Q) + cw * 64 * 128;  // this warpgroup's rows of each panel
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % L::STAGES, n0 = i * FWD_BN;
      const uint32_t sk = opaque(smem_u32(smem + L::KV + s * 2 * L::KV_BYTES)), sv = sk + L::KV_BYTES;
      const uint32_t q_t = opaque(sq);
      mbar_wait(&full[s], (i / L::STAGES) & 1);

      // S = Q K^T, raw (unscaled) scores
      float sc[FWD_BN / 2];
      wg_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) Wgmma<FWD_BN>::ss<0>(sc, desc_k<FWD_BM>(q_t, k), desc_k<FWD_BN>(sk, k), k > 0);
      wg_commit();
      wg_wait<0>();
      touch<FWD_BN / 2>(sc);

      // the mask, only where the tile needs one; masked scores become -inf
      const bool masked = a.ksegs != nullptr || n0 + FWD_BN > a.C || (a.diagonal && n0 + FWD_BN - 1 > r_lo);
      if (masked) {
        const int* seg = sseg + s * FWD_BN;
#pragma unroll
        for (int j = 0; j < FWD_BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, cl = j * 8 + tig * 2 + (e & 1), col = n0 + cl;
            const bool ok = col < a.C && (!a.diagonal || col <= row[r]) && (!a.ksegs || qseg[r] == seg[cl]);
            if (!ok) sc[4 * j + e] = -INFINITY;
          }
        }
      }
      // online softmax: the row max over this thread's columns, then the quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < FWD_BN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float corr[2], mb[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * a.scale);  // stays >= -1e30
        corr[r] = exp2_approx((m[r] - m_new) * LOG2E);
        m[r] = m_new;
        mb[r] = m_new * LOG2E;
      }
#pragma unroll
      for (int j = 0; j < FWD_BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(sc[4 * j + e], c1, -mb[e >> 1]));  // 0 where masked
          sc[4 * j + e] = p;
          ls[e >> 1] += p;
        }
      }
      l[0] = l[0] * corr[0] + ls[0];
      l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0]; o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1]; o[4 * j + 3] *= corr[1];
      }

      // O += P V, P rounded to the input type as the TPU kernel does
      uint32_t pa[FWD_BN / 16][4];
#pragma unroll
      for (int k = 0; k < FWD_BN / 16; ++k) pack_a<T>(pa[k], sc, k);
      touch<D / 2>(o);
      wg_fence();
#pragma unroll
      for (int k = 0; k < FWD_BN / 16; ++k) Wgmma<D>::template rs<1>(o, pa[k], desc_mn<FWD_BN>(sv, k), 1);
      wg_commit();
      wg_wait<0>();
      touch<D / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (row[r] >= a.C) continue;
      if (a.finalize) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        uint16_t* op = a.o + b * a.os.b + h * a.os.h + (long long)row[r] * a.os.s;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(op + j * 8 + tig * 2) = pack<T>(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
        if (tig == 0) a.lse[st0 + row[r]] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
      } else {
        float* ap = a.acc + b * a.accs.b + h * a.accs.h + (long long)row[r] * a.accs.s;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(ap + j * 8 + tig * 2) = make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if (tig == 0) {
          a.m[st0 + row[r]] = m[r];
          a.l[st0 + row[r]] = l[r];
        }
      }
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const Strides& qs, const Strides& ks, const Strides& vs,
           const RingFwdArgs& a, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode_rows(&tq, q, D, a.C, a.H, B, qs.s, qs.h, qs.b, FWD_BM);
  if (rc == 0) rc = encode_rows(&tk, k, D, a.C, a.KH, B, ks.s, ks.h, ks.b, FWD_BN);
  if (rc == 0) rc = encode_rows(&tv, v, D, a.C, a.KH, B, vs.s, vs.h, vs.b, FWD_BN);
  if (rc != 0) return rc;
  const int smem = FwdSmem<D>::BYTES + 1024;  // and room to align the base to 1024
  cudaFuncSetAttribute(ring_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(a.H, B, (a.C + FWD_BM - 1) / FWD_BM);
  ring_fwd_kernel<D, T><<<grid, FWD_THREADS, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 q/k/v/o, fp32 state. Returns cudaGetLastError() after the launch, -1
// for a head_dim this kernel does not take, -2 or -3 if a tensor map cannot
// be made (mt::encode_rows).
extern "C" int mt_ring_fwd(
    const void* q, const void* k, const void* v, const void* qsegs, const void* ksegs,
    void* acc, void* m, void* l, void* o, void* lse,
    int B, int H, int KH, int C, int D, int diagonal, int first, int finalize, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long acc_sb, long long acc_ss, long long acc_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long st_sb, long long st_sh, long long qseg_sb, long long kseg_sb,
    void* stream) {
  mt::RingFwdArgs a{};
  a.qsegs = static_cast<const int*>(qsegs); a.ksegs = static_cast<const int*>(ksegs);
  a.acc = static_cast<float*>(acc); a.m = static_cast<float*>(m); a.l = static_cast<float*>(l);
  a.o = static_cast<uint16_t*>(o); a.lse = static_cast<float*>(lse);
  a.H = H; a.KH = KH; a.C = C; a.diagonal = diagonal; a.first = first; a.finalize = finalize;
  a.scale = scale;
  a.accs = {acc_sb, acc_ss, acc_sh}; a.os = {o_sb, o_ss, o_sh};
  a.st = {st_sb, st_sh}; a.qseg_b = qseg_sb; a.kseg_b = kseg_sb;
  const mt::Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return mt::launch<128, __nv_bfloat16>(q, k, v, qs, ks, vs, a, B, st);
  if (D == 64) return mt::launch<64, __nv_bfloat16>(q, k, v, qs, ks, vs, a, B, st);
  return -1;
}
