// Flash attention (GQA, causal / sliding window, absolute query offset) for
// sm_90a.  Replaces src/repro/kernels/flash_attention.py::flash_attention,
// body _fa_kernel (pallas_call at :122).
//
// What it computes, as _fa_kernel does.  q (B,H,Tq,hd), k/v (B,K,Tk,hd);
// query row i of head h sits at absolute position q_pos = q_offset + i and
// reads kv head h / (H / K).  Key j is live iff j < Tk, j <= q_pos (causal)
// and j > q_pos - window (window).  Score s = (q . k) * scale with scale =
// 1/sqrt(hd); online softmax with the running max m (from -1e30), sum l and
// accumulator in float32 and expf; out = acc / max(l, 1e-20) in q's type,
// so a row with no live key gives 0.  Inputs are float32 or bfloat16 (q
// and k/v may differ) and are widened to float32 on load.
//
// Design.  The TPU grid's sequential kv axis, which carried (m, l, acc) in
// VMEM scratch from one grid step to the next, becomes a loop inside one
// block per (b*h, 64-row q tile): blocks run in parallel and in no order
// on the card.  The loop visits only the kv tiles that hold a live key for
// some row of the q tile (up to the causal frontier, from the window's
// trailing edge), which skips the wholly masked tiles as pl.when did.  Each
// tile of 64 keys is staged in shared memory as float32 (rows past Tk are
// zeros, as _fa_kernel zeroes its ragged tail), then
//   S = Q K^T * scale  256 threads, a 4x4 patch each (rows ty+16i, cols tx+16j);
//   softmax            one warp per 8 rows, two scores per lane, shuffles;
//   acc = acc*corr + P V   each thread keeps rows ty+16i, columns tx+16j of
//                      acc in registers.
// Rows past Tq (a ragged tail; decode's single row) are skipped.  Inputs
// are read through strides (the last dimension contiguous), so the model
// layout (B,T,H,hd) and the KV cache need no copy.
//
// Bound.  At the serve path's shapes attention is bound by operations in
// prefill (T = 1000, GQA 4:1: ~400 flop per byte) and by bytes in decode
// (~4 flop per byte of cache).  This first kernel runs float32 FMAs on the CUDA
// cores out of shared memory and is bound by its shared-memory loads, far
// from either; wgmma/TMA come later (and would run p @ v in bf16, which
// changes the numerics the plain version pins).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // keys per kv tile
constexpr int NT = 256;          // threads per block, 16 x 16
constexpr int MAX_HD = 128;
constexpr int NJ = MAX_HD / 16;  // acc columns a thread holds, at most
constexpr int RW = BQ / (NT / 32);  // softmax rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

}  // namespace

// Mirrored field for field by FaArgs in kernels/flash_attention.py.
struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;                        // (B,H,Tq,hd), contiguous, q's type
  long long sq[3], sk[3], sv[3];  // element strides of dims 0, 1, 2
  int B, H, K, Tq, Tk, hd;
  int causal, window, q_offset;   // window <= 0: no window
  float scale;
};

namespace {

__device__ __forceinline__ bool live(const FaArgs& a, int qp, int kp) {
  return kp < a.Tk && (!a.causal || kp <= qp) &&
         (a.window <= 0 || kp > qp - a.window);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int hd) {
  const int ldq = hd | 1;  // odd row stride: the K reads of a warp hit 16 banks
  return sizeof(float) *
         (size_t)(BQ * ldq + BK * ldq + BK * hd + BQ * (BK + 1) + BQ);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(NT) fa_kernel(const FaArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ldq = hd | 1;
  float* qs = smem;                 // BQ x ldq
  float* ks = qs + BQ * ldq;        // BK x ldq
  float* vs = ks + BK * ldq;        // BK x hd
  float* ps = vs + BK * hd;         // BQ x (BK + 1): scores, then p
  float* rowv = ps + BQ * (BK + 1);  // per row: corr, at the end l

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int kh = h / (a.H / a.K);
  // the last q tiles have the most live kv tiles under a causal mask: start
  // them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int n_rows = min(BQ, a.Tq - q0);
  const TQ* q = static_cast<const TQ*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const TKV* k = static_cast<const TKV*>(a.k) + b * a.sk[0] + kh * a.sk[1];
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.sv[0] + kh * a.sv[1];
  TQ* o = static_cast<TQ*>(a.o) + ((long long)bh * a.Tq + q0) * hd;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  // rows ty + 16 i of this thread that lie before Tq
  const int nri = ty < n_rows ? min(4, (n_rows - ty + 15) / 16) : 0;

  for (int e = tid; e < BQ * hd; e += NT) {
    const int r = e / hd, d = e - r * hd;
    qs[r * ldq + d] = r < n_rows ? widen(q[(q0 + r) * a.sq[2] + d]) : 0.f;
  }

  const int first_q = q0 + a.q_offset, last_q = first_q + n_rows - 1;
  int k_lo = 0, k_hi = a.Tk;
  if (a.causal) k_hi = min(k_hi, last_q + 1);
  if (a.window > 0) k_lo = max(0, first_q - a.window + 1);
  k_lo -= k_lo % BK;

  float m_run[RW], l_run[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m_run[rr] = NEG_INF;
    l_run[rr] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // Q staged; the previous tile's K, V and P consumed
    for (int e = tid; e < BK * hd; e += NT) {
      const int r = e / hd, d = e - r * hd;
      const bool in = k0 + r < a.Tk;
      ks[r * ldq + d] = in ? widen(k[(long long)(k0 + r) * a.sk[2] + d]) : 0.f;
      vs[r * hd + d] = in ? widen(v[(long long)(k0 + r) * a.sv[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // threads with no row before Tq (decode: all but 16) skip the products
    for (int d = 0; d < (nri > 0 ? hd : 0); ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < nri)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (i < nri)
          ps[r * (BK + 1) + c] =
              live(a, first_q + r, k0 + c) ? s[i][j] * a.scale : NEG_INF;
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      if (r >= n_rows) continue;  // warp-uniform
      float* row = ps + r * (BK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_new = fmaxf(m_run[rr], warp_max(fmaxf(s0, s1)));
      const int qp = first_q + r;
      const float p0 = live(a, qp, k0 + lane) ? expf(s0 - m_new) : 0.f;
      const float p1 = live(a, qp, k0 + lane + 32) ? expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      const float corr = expf(m_run[rr] - m_new);
      l_run[rr] = l_run[rr] * corr + sum;
      m_run[rr] = m_new;
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) rowv[r] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = i < nri ? rowv[ty + 16 * i] : 1.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= c;
    }
    for (int kk = 0; kk < (nri > 0 ? BK : 0); ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < hd ? vs[kk * hd + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < nri) acc[i][j] = __fmaf_rn(pv[i], vv, acc[i][j]);
      }
    }
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
      if (warp * RW + rr < n_rows) rowv[warp * RW + rr] = l_run[rr];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float l = i < nri ? fmaxf(rowv[r], 1e-20f) : 1.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (i < nri && c < hd) put(o + (long long)r * hd + c, acc[i][j] / l);
    }
  }
}

template <typename TQ, typename TKV>
int launch(const FaArgs& a, cudaStream_t stream) {
  static bool opted_in = false;  // above 48 KB only after an opt-in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_HD));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid(a.B * a.H, (a.Tq + BQ - 1) / BQ);
  fa_kernel<TQ, TKV><<<grid, NT, smem_bytes(a.hd), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int flash_attention(const FaArgs* a, int q_bf16, int kv_bf16,
                               cudaStream_t stream) {
  if (a->hd < 1 || a->hd > MAX_HD || a->Tq < 1 || a->Tk < 1 || a->K < 1 ||
      a->H % a->K != 0 || (a->Tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(*a, stream);
  if (q_bf16) return launch<__nv_bfloat16, float>(*a, stream);
  if (kv_bf16) return launch<float, __nv_bfloat16>(*a, stream);
  return launch<float, float>(*a, stream);
}
