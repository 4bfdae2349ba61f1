// Mamba2 SSD chunked scan for sm_90a.  Replaces
// src/repro/kernels/ssd_scan.py::ssd_scan, body _ssd_kernel (pallas_call
// at :83).
//
// What it computes, as _ssd_kernel does.  x (B,T,H,P), dt (B,T,H), A (H,),
// B/C (B,T,N) shared across heads.  For each (b, h), chunk after chunk of
// L = min(chunk, T) steps, all in float32:
//   lam = dt*A,  cs = cumsum(lam) over the chunk,  dtx = dt*x;
//   y   = (C B^T o decay) @ dtx + exp(cs) o (C @ state),
//         decay[l][m] = exp(cs_l - cs_m) for m <= l, else 0;
//   state <- exp(cs_L) * state + (B o exp(cs_L - cs))^T @ dtx.
// y is written in y's type (x's), the final (N,P) state once per (b, h)
// in float32 after the last chunk.  x and B/C are float32 or bfloat16,
// widened on load.
//
// Design.  The TPU grid's sequential chunk axis, which carried the (N,P)
// state in VMEM scratch, becomes a loop inside one block: blocks run in
// parallel and in no order.  Columns of P are independent (y[:, p] and
// state[:, p] read x[:, p] only), so a block owns one (b, h) and a slice of
// PS = 32 columns, which fills the card at one long prompt (1 x 4096 at 80
// heads: 160 blocks) at the cost of computing C B^T once per slice.  Per
// chunk the block stages dt, cs, exp(cs_L - cs), dt*x (L x PS), C^T and
// B^T (N x L, transposed so that four rows are one float4) in shared
// memory; the state (N x PS) stays there across chunks.  Then
//   y_inter  each thread a 4x4 patch of (rows, columns): C @ state;
//   C B^T    each thread three 4x4 patches of the L x L product (the patch
//            of rows < 64 and columns >= 64 lies wholly above the
//            diagonal and is skipped), masked and decayed into P^T, which
//            takes C^T's place;
//   y_intra  P @ dtx, each warp stopping at its last row (P is 0 above
//            the diagonal);
//   state    each thread a 4x4 patch of (N, PS).
// The masked exponential: exp(cs_l - cs_m) is taken only where m <= l, so
// no inf (the difference is positive above the diagonal) reaches a
// product.  Rows past L (L < 128) are zeros and are never stored.
//
// Bound.  At mamba2-2.7b's prefill (4096 tokens, 80 heads, P = 64,
// N = 128) the function needs ~13 GFLOP of float32 (per (b, h, chunk) the
// causal half of P @ dtx, C @ state past the first chunk and the state
// update; C B^T once per (b, chunk)) against ~184 MB moved: bound by
// operations (float32 FMAs; the tensor cores' TF32 would move the
// numbers the plain version pins).  This first kernel runs float32 FMAs on
// the CUDA cores out of shared memory, one block of 256 threads per SM
// (165.5 KiB of shared memory at N = 128), and recomputes C B^T for every
// (head, slice); a C B^T pass per (b, chunk) and wgmma/TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int PS = 32;          // columns of P per block
constexpr int MAX_L = 128;      // chunk length, at most
constexpr int MAX_N = 128;      // state size, at most
constexpr int LD = MAX_L + 4;   // row stride of the (., L) tiles: float4 rows

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void outer(float (&acc)[4][4], const float4 a,
                                      const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

}  // namespace

// Mirrored field for field by SsdArgs in kernels/ssd_scan.py.
struct SsdArgs {
  const void* x;    // (B,T,H,P) contiguous, float32 or bfloat16
  const float* dt;  // (B,T,H) contiguous
  const float* A;   // (H,)
  const void* Bm;   // (B,T,N) contiguous, float32 or bfloat16 (as Cm)
  const void* Cm;   // (B,T,N) contiguous
  void* y;          // (B,T,H,P) contiguous, x's type
  float* state;     // (B,H,N,P) contiguous: the final state
  int B, T, H, P, N, L;
};

namespace {

size_t smem_bytes(int N) {
  const int rows_a = N > MAX_L ? N : MAX_L;  // C^T (N rows), then P^T (L)
  return sizeof(float) * (size_t)(rows_a * LD + N * LD + MAX_L * PS +
                                  N * PS + 3 * MAX_L);
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(NT, 1) ssd_kernel(const SsdArgs a) {
  extern __shared__ float smem[];
  const int N = a.N, L = a.L, H = a.H, P = a.P;
  const int rows_a = N > MAX_L ? N : MAX_L;
  float* ct = smem;              // C^T: ct[n*LD + l]; then P^T: [m*LD + l]
  float* bt = ct + rows_a * LD;  // B^T: bt[n*LD + l]
  float* dtx = bt + N * LD;      // dt*x: dtx[l*PS + p]
  float* st = dtx + MAX_L * PS;  // state: st[n*PS + p]
  float* dts = st + N * PS;      // dt
  float* css = dts + MAX_L;      // cs
  float* ws = css + MAX_L;       // exp(cs_L - cs)

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const float A_h = a.A[h];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // y and state patches: rows 4ty..4ty+3, columns 4tx..4tx+3 of the slice
  const int tx = tid & 7, ty = tid >> 3;
  // C B^T patches: rows {r, 64 + r}, columns {c, 64 + c}
  const int cr = 4 * (tid >> 4), cc = 4 * (tid & 15);
  const bool hi = L > 64;                   // rows and columns past 64 live
  const bool rows_live = 16 * warp < L;     // this warp has a row < L
  const int m_end = min(L, 16 * warp + 16);  // P is 0 past the warp's rows
  const bool st_live = 16 * warp < N;       // this warp has a state row

  const TX* x = static_cast<const TX*>(a.x);
  const TBC* Bm = static_cast<const TBC*>(a.Bm);
  const TBC* Cm = static_cast<const TBC*>(a.Cm);
  TX* y = static_cast<TX*>(a.y);

  for (int e = tid; e < N * PS; e += NT) st[e] = 0.f;

  const int n_chunks = a.T / L;
  for (int c = 0; c < n_chunks; ++c) {
    const long long row0 = (long long)b * a.T + (long long)c * L;  // (b, t0)
    // ---- stage dt, then cs and the weights; dt*x, C^T and B^T ----------
    if (tid < MAX_L)
      dts[tid] = tid < L ? a.dt[(row0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (warp == 0) {
      // cs in order, one step after the other, as torch.cumsum (and the
      // plain version) sums along the chunk axis: the decays exp(cs_l -
      // cs_m) take differences of these sums, which a reordered scan would
      // round differently
      if (lane == 0) {
        float run = 0.f;
        for (int l = 0; l < MAX_L; ++l) {
          run += l < L ? dts[l] * A_h : 0.f;
          css[l] = run;
        }
      }
      __syncwarp();
      const float cl = css[L - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = 4 * lane + k;
        ws[l] = l < L ? expf(cl - css[l]) : 0.f;
      }
    }
    for (int e = tid; e < MAX_L * PS; e += NT) {
      const int l = e / PS, p = e - l * PS;
      dtx[e] = (l < L && p0 + p < P)
                   ? dts[l] * widen(x[((row0 + l) * H + h) * P + p0 + p])
                   : 0.f;
    }
    for (int e = tid; e < N * MAX_L; e += NT) {
      const int l = e / N, n = e - l * N;
      const bool in = l < L;
      ct[n * LD + l] = in ? widen(Cm[(row0 + l) * N + n]) : 0.f;
      bt[n * LD + l] = in ? widen(Bm[(row0 + l) * N + n]) : 0.f;
    }
    __syncthreads();

    // ---- y_inter = exp(cs) o (C @ state); the state is 0 in chunk 0 ------
    float yi[4][4];
    zero(yi);
    if (c > 0 && rows_live) {
      for (int n = 0; n < N; ++n)
        outer(yi, ld4(ct + n * LD + 4 * ty), ld4(st + n * PS + 4 * tx));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(css[4 * ty + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = e * yi[i][j];
      }
    }

    // ---- C B^T, three 4x4 patches a thread -------------------------------
    float ll[4][4], hl[4][4], hh[4][4];
    zero(ll);
    zero(hl);
    zero(hh);
    if (hi) {
      for (int n = 0; n < N; ++n) {
        const float4 rl = ld4(ct + n * LD + cr), rh = ld4(ct + n * LD + 64 + cr);
        const float4 ql = ld4(bt + n * LD + cc), qh = ld4(bt + n * LD + 64 + cc);
        outer(ll, rl, ql);
        outer(hl, rh, ql);
        outer(hh, rh, qh);
      }
    } else {
      for (int n = 0; n < N; ++n)
        outer(ll, ld4(ct + n * LD + cr), ld4(bt + n * LD + cc));
    }
    __syncthreads();  // every read of C^T and of the state is done

    // ---- P^T[m][l] = C B^T[l][m] * exp(cs_l - cs_m) for m <= l < L --------
    auto emit = [&](const float (&cb)[4][4], int r0, int c0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = c0 + j;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + i;
          v[i] = (l < L && m <= l) ? cb[i][j] * expf(css[l] - css[m]) : 0.f;
        }
        *reinterpret_cast<float4*>(ct + m * LD + r0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    };
    emit(ll, cr, cc);
    if (hi) {
      emit(hl, 64 + cr, cc);
      emit(hh, 64 + cr, 64 + cc);
    }
    __syncthreads();

    // ---- y = P @ dtx + y_inter ------------------------------------------
    if (rows_live) {
      float ya[4][4];
      zero(ya);
      for (int m = 0; m < m_end; ++m)
        outer(ya, ld4(ct + m * LD + 4 * ty), ld4(dtx + m * PS + 4 * tx));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = 4 * ty + i;
        if (l >= L) continue;
        TX* yr = y + ((row0 + l) * H + h) * P + p0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p0 + 4 * tx + j < P) put(yr + 4 * tx + j, ya[i][j] + yi[i][j]);
      }
    }

    // ---- state <- exp(cs_L) * state + (B o w)^T @ dtx (own patch) --------
    if (st_live) {
      float sa[4][4];
      zero(sa);
      for (int l = 0; l < L; ++l) {
        const float w = ws[l];
        float bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * ty + i;
          bw[i] = n < N ? bt[n * LD + l] * w : 0.f;
        }
        outer(sa, make_float4(bw[0], bw[1], bw[2], bw[3]),
              ld4(dtx + l * PS + 4 * tx));
      }
      const float eL = expf(css[L - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 4 * ty + i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* s = st + n * PS + 4 * tx + j;
          *s = eL * *s + sa[i][j];
        }
      }
    }
    __syncthreads();  // the next chunk overwrites every staged tile
  }

  for (int e = tid; e < N * PS; e += NT) {
    const int n = e / PS, p = e - n * PS;
    if (p0 + p < P)
      a.state[(((long long)b * H + h) * N + n) * P + p0 + p] = st[e];
  }
}

template <typename TX, typename TBC>
int launch(const SsdArgs& a, cudaStream_t stream) {
  static bool opted_in = false;  // above 48 KB only after an opt-in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<TX, TBC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_N));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((a.P + PS - 1) / PS, a.H, a.B);
  ssd_kernel<TX, TBC><<<grid, NT, smem_bytes(a.N), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x_bf16 / bc_bf16: 1 for bfloat16 x (and y) / B and C, 0 for float32.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int ssd_scan(const SsdArgs* a, int x_bf16, int bc_bf16,
                        cudaStream_t stream) {
  if (a->B < 1 || a->B > 65535 || a->H < 1 || a->H > 65535 || a->P < 1 ||
      a->N < 1 || a->N > MAX_N || a->L < 1 || a->L > MAX_L || a->T < 1 ||
      a->T % a->L != 0)
    return (int)cudaErrorInvalidValue;
  if (x_bf16 && bc_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(*a, stream);
  if (x_bf16) return launch<__nv_bfloat16, float>(*a, stream);
  if (bc_bf16) return launch<float, __nv_bfloat16>(*a, stream);
  return launch<float, float>(*a, stream);
}
