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
// (q tile of 64 rows, head, batch) walks the KV tiles in a loop with m, l
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
// gives no inf - inf. Tiles above the causal diagonal are never loaded; the
// ragged edge is zero-filled and masked.
//
// Bound on the H100: a full 2048 x 2048 step at D = 128 does about 2 * C * D
// flops per byte of q/k/v and state moved, far above the ~295 flop/byte
// ridge: bound by tensor-core operations. This first version multiplies with
// mma.sync from single-buffered shared tiles; wgmma, TMA and a pipelined
// producer warp are later work.
#include "flash_common.cuh"

namespace mt {

struct RingFwdArgs {
  const uint16_t* q; const uint16_t* k; const uint16_t* v; const int* qsegs; const int* ksegs;
  float* acc; float* m; float* l; uint16_t* o; float* lse;
  int H, KH, C, diagonal, first, finalize; float scale;
  Strides qs, ks, vs, accs, os;
  RowStrides st;  // m, l and lse
  long long qseg_b, kseg_b;
};

template <int D, typename T>
__global__ void __launch_bounds__(NT) ring_fwd_kernel(const RingFwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sK = sQ + tile_elems(D);
  uint16_t* sV = sK + tile_elems(D);
  int* sSeg = reinterpret_cast<int*>(sV + tile_elems(D));
  constexpr int LD = pitch(D);

  // heaviest diagonal tiles first: they start while the light ones fill in
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const uint16_t* qp = a.q + b * a.qs.b + h * a.qs.h;
  const uint16_t* kp = a.k + b * a.ks.b + kh * a.ks.h;
  const uint16_t* vp = a.v + b * a.vs.b + kh * a.vs.h;
  const int* qsegs = a.qsegs ? a.qsegs + b * a.qseg_b : nullptr;
  const int* ksegs = a.ksegs ? a.ksegs + b * a.kseg_b : nullptr;
  const long long st0 = b * a.st.b + h * a.st.h;

  load_tile<D>(sQ, qp, a.qs.s, q0, a.C, tid);
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  int qseg[2] = {0, 0};
  if (qsegs) {
    for (int i = 0; i < 2; ++i) qseg[i] = row[i] < a.C ? qsegs[row[i]] : -2;
  }

  // the running state: fresh on the first step, else this tile's rows from
  // device memory. l is a per-thread partial sum, so the quad's first thread
  // takes the stored total and the others start at 0.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (!a.first) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.C) continue;
      m[r] = a.m[st0 + row[r]];
      if (tig == 0) l[r] = a.l[st0 + row[r]];
      const float* ap = a.acc + b * a.accs.b + h * a.accs.h + (long long)row[r] * a.accs.s;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float2 x = *reinterpret_cast<const float2*>(ap + dt * 8 + tig * 2);
        acc[dt][2 * r] = x.x;
        acc[dt][2 * r + 1] = x.y;
      }
    }
  }

  const int kv_end = a.diagonal ? min(a.C, q0 + BM) : a.C;
  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    load_tile<D>(sK, kp, a.ks.s, n0, a.C, tid);
    load_tile<D>(sV, vp, a.vs.s, n0, a.C, tid);
    load_segs(sSeg, ksegs, n0, a.C, tid);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t af[4];
      load_a(af, sQ, LD, warp * 16, kk, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bf[2];
        load_bt(bf, sK, LD, nt * 8, kk, lane);
        mma<T>(s[nt], af, bf);
      }
    }

    // scale and mask; running row max over this thread's columns, then the quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, cl = nt * 8 + tig * 2 + (e & 1), col = n0 + cl;
        const bool ok = col < a.C && (!a.diagonal || col <= row[r]) && (!ksegs || qseg[r] == sSeg[cl]);
        const float x = ok ? s[nt][e] * a.scale : NEG_INF;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[nt][e] > 0.5f * NEG_INF ? __expf(s[nt][e] - m[r]) : 0.f;
        s[nt][e] = p;
        ls[r] += p;
      }
    }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr[0]; acc[i][1] *= corr[0];
      acc[i][2] *= corr[1]; acc[i][3] *= corr[1];
    }
    // acc += P V, P rounded to the input type as the TPU kernel does
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s, j);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bf[2];
        load_b(bf, sV, LD, j * 16, dt * 8, lane);
        mma<T>(acc[dt], pa, bf);
      }
    }
    __syncthreads();  // the next tile overwrites sK/sV
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
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(op + dt * 8 + tig * 2) =
            pack<T>(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
      }
      if (tig == 0) a.lse[st0 + row[r]] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    } else {
      float* ap = a.acc + b * a.accs.b + h * a.accs.h + (long long)row[r] * a.accs.s;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(ap + dt * 8 + tig * 2) = make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
      if (tig == 0) {
        a.m[st0 + row[r]] = m[r];
        a.l[st0 + row[r]] = l[r];
      }
    }
  }
}

template <int D, typename T>
int launch(const RingFwdArgs& a, int B, cudaStream_t stream) {
  const int smem = 3 * tile_elems(D) * 2 + BN * 4;
  cudaFuncSetAttribute(ring_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((a.C + BM - 1) / BM, a.H, B);
  ring_fwd_kernel<D, T><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 q/k/v/o, fp32 state. Returns cudaGetLastError() after the launch, or
// -1 for a head_dim this kernel does not take.
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
  a.q = static_cast<const uint16_t*>(q); a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.qsegs = static_cast<const int*>(qsegs); a.ksegs = static_cast<const int*>(ksegs);
  a.acc = static_cast<float*>(acc); a.m = static_cast<float*>(m); a.l = static_cast<float*>(l);
  a.o = static_cast<uint16_t*>(o); a.lse = static_cast<float*>(lse);
  a.H = H; a.KH = KH; a.C = C; a.diagonal = diagonal; a.first = first; a.finalize = finalize;
  a.scale = scale;
  a.qs = {q_sb, q_ss, q_sh}; a.ks = {k_sb, k_ss, k_sh}; a.vs = {v_sb, v_ss, v_sh};
  a.accs = {acc_sb, acc_ss, acc_sh}; a.os = {o_sb, o_ss, o_sh};
  a.st = {st_sb, st_sh}; a.qseg_b = qseg_sb; a.kseg_b = kseg_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return mt::launch<128, __nv_bfloat16>(a, B, st);
  if (D == 64) return mt::launch<64, __nv_bfloat16>(a, B, st);
  return -1;
}
