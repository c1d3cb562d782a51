// Flash-attention forward for Hopper.
//
// Replaces maggy_tpu/ops/flash.py::_fwd_kernel (launched by _fwd_call). Same
// math: causal and/or segment-masked GQA attention with an fp32 online softmax
// (m, l, acc), masked logits at -1e30 and masked p at 0, O in the input type
// and a per-row LSE that is +inf where no key is visible (O is 0 there).
//
// What differs from the TPU kernel: the TPU walked the KV blocks as the last,
// sequential grid axis and carried (m, l, acc) in VMEM scratch between grid
// steps. Here one CTA per (q tile of 64 rows, head, batch) walks the KV tiles
// in a loop and keeps m, l and acc in registers; the CTAs run in parallel
// over the 132 SMs. GQA lives in the addressing (KV head = h / group), so the
// repeated K/V never exist. q/k/v are read in their [B, S, H, D] layout through
// strides, with no transposed copy. Tiles above the causal diagonal are never
// loaded; the ragged S edge is zero-filled and masked.
//
// Bound on the H100: at S = 2048, D = 128 the work is about 2 * S * D flops per
// byte of q/k/v read, far above the ~295 flop/byte ridge, so it is bound by
// tensor-core operations. This first version multiplies with mma.sync from
// single-buffered shared tiles; wgmma, TMA and a pipelined producer warp are
// the later work that approaches that bound.
#include "flash_common.cuh"

namespace mt {

struct FwdArgs {
  const uint16_t* q; const uint16_t* k; const uint16_t* v; const int* segs;
  uint16_t* o; float* lse;
  int H, KH, Sq, Sk, causal; float scale;
  Strides qs, ks, vs, os;
};

template <int D, typename T>
__global__ void __launch_bounds__(NT) fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sK = sQ + tile_elems(D);
  uint16_t* sV = sK + tile_elems(D);
  int* sSeg = reinterpret_cast<int*>(sV + tile_elems(D));
  constexpr int LD = pitch(D);

  // heaviest causal tiles first: they start while the light ones fill in
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const uint16_t* qp = a.q + b * a.qs.b + h * a.qs.h;
  const uint16_t* kp = a.k + b * a.ks.b + kh * a.ks.h;
  const uint16_t* vp = a.v + b * a.vs.b + kh * a.vs.h;
  const int* segs = a.segs ? a.segs + (long long)b * a.Sk : nullptr;

  load_tile<D>(sQ, qp, a.qs.s, q0, a.Sq, tid);
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  int qseg[2] = {0, 0};
  if (segs) {
    for (int i = 0; i < 2; ++i) qseg[i] = row[i] < a.Sq ? segs[row[i]] : -2;
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int kv_end = a.causal ? min(a.Sk, q0 + BM) : a.Sk;
  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    load_tile<D>(sK, kp, a.ks.s, n0, a.Sk, tid);
    load_tile<D>(sV, vp, a.vs.s, n0, a.Sk, tid);
    load_segs(sSeg, segs, n0, a.Sk, tid);
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
        const bool ok = col < a.Sk && (!a.causal || col <= row[r]) && (!segs || qseg[r] == sSeg[cl]);
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
    // l stays a per-thread partial sum until the end: corr is uniform per row
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
    if (row[r] >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    uint16_t* op = a.o + b * a.os.b + h * a.os.h + (long long)row[r] * a.os.s;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8 + tig * 2) =
          pack<T>(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (tig == 0) {
      a.lse[((long long)b * a.H + h) * a.Sq + row[r]] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    }
  }
}

template <int D, typename T>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const int smem = 3 * tile_elems(D) * 2 + BN * 4;
  cudaFuncSetAttribute(fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((a.Sq + BM - 1) / BM, a.H, B);
  fwd_kernel<D, T><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mt

// bf16 operands. Returns cudaGetLastError() after the launch, or -1 for a
// head_dim this kernel does not take.
extern "C" int mt_flash_fwd(
    const void* q, const void* k, const void* v, const void* segs, void* o, void* lse,
    int B, int H, int KH, int Sq, int Sk, int D, int causal, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  mt::FwdArgs a{
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int*>(segs),
      static_cast<uint16_t*>(o), static_cast<float*>(lse),
      H, KH, Sq, Sk, causal, scale,
      {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return mt::launch<128, __nv_bfloat16>(a, B, st);
  if (D == 64) return mt::launch<64, __nv_bfloat16>(a, B, st);
  return -1;
}
