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
// Bound.  At mamba2-2.7b's prefill (4096 tokens, 80 heads, P = 64,
// N = 128) the function needs ~13.3 GFLOP (per (b, h, chunk) the causal
// half of the intra product, C @ state past the first chunk and the state
// update; C B^T once per (b, chunk)) against ~176 MB moved: 0.199 ms of
// float32 FMAs at 67 TFLOP/s, bound by operations.  The chunk states'
// round trip through device memory adds ~340 MB a call.
//
// Numbers.  Every sum runs over its depth in order, one float32 FMA after
// another, as the plain version's products do (cuBLAS, float32), and every
// other operation is the plain version's own, in its order: the kernel
// gives the plain version's y and state bit for bit.  The serve check
// needs that: a 64-layer Mamba2 stack of random bf16 weights amplifies a
// 1e-7 relative change of the scan's output to several per cent of the
// logits (chip_smoke.py logs it), over SERVE_REL_L2, and TF32 products,
// even split three ways (3xTF32, tests/test_torch_ssd_split.py), change
// it by more.
//
// Design.  The first kernel (one block per (b, h, 32 columns of P)
// walking the chunks in order) lost its time to C B^T recomputed for
// every head and slice, 160 blocks on 132 SMs at one long prompt, and a
// serial cumsum a chunk with 255 threads waiting.  Here the chunkwise SSD
// algorithm (Dao & Gu, arXiv:2405.21060, §6-7) runs in four launches, the
// sequential chunk axis of the TPU grid reduced to one elementwise
// recurrence:
//   ssd_cb_kernel     per (b, chunk): C B^T's lower triangle, once for
//                     every head, stored transposed; and C^T.
//   ssd_state_kernel  per (b, h, chunk, 64 columns of P): cs summed in
//                     order by one thread (torch.cumsum's order: the
//                     decays exp(cs_l - cs_m) amplify a reordered
//                     rounding) while the copies of B and x are in
//                     flight; the chunk's own state S_c = (B o w)^T @ dtx.
//   ssd_pass_kernel   per (b, h), elementwise over N x P, chunk after
//                     chunk: the reference's update state = exp(cs_L) *
//                     state + S_c, each S_c overwritten in place by the
//                     state its chunk starts from; the final state.
//   ssd_out_kernel    per (b, h, chunk, 64 columns): y_inter = exp(cs) o
//                     (C @ S_in), then y_intra = (C B^T o decay) @ dtx,
//                     the masked exponential taken only where m <= l, each
//                     warp stopping at its last row; y = y_intra + y_inter.
// Passes 2 and 4 run 2560 blocks of 256 threads at mamba2's prefills, two
// a SM; each thread sums a 4 x 8 tile (four rows, eight columns) from
// float4 reads of shared memory, whose tiles come in with cp.async, every
// copy in flight at once.  Rows past L and columns past P are never
// stored.
//
// Backward (ssd_scan_bwd, five launches; float32 only).  The TPU kernel
// has none: the reference trains through XLA's gradient of the jnp
// ssd_chunked.  Per (b, h, chunk c) with G_c the gradient of the state
// leaving chunk c (G of the last chunk: the final state's, or 0) and S_in
// the state entering it (the forward's scratch `st`):
//   Q_c   = sum_l exp(cs_l) C_l (x) dy_l;  G_{c-1} = exp(cs_L) G_c + Q_c
//   DY[l][m] = dy_l . dtx_m,  D[l][m] = exp(cs_l - cs_m) (m <= l, else 0)
//   W = DY o D,  M = (C B^T) o D,  E = W o (C B^T)
//   ddtx_m = sum_l M[l][m] dy_l + w_m B_m G_c   (w_m = exp(cs_L - cs_m))
//   dC_l   = sum_m W[l][m] B_m + exp(cs_l) S_in dy_l
//   dB_m   = sum_l W[l][m] C_l + w_m G_c dtx_m
//   dcs_l  = sum_m E[l][m] - sum_m E[m][l] + C_l . (exp(cs_l) S_in dy_l)
//            - u_l  (+ exp(cs_L) <G_c, S_in> + sum_m u_m at l = L-1),
//            u_m = (w_m B_m G_c) . dtx_m
//   dlam = the in-chunk reverse cumsum of dcs;  ddt = dlam A + ddtx . x;
//   dx = dt ddtx;  dA = sum over (b, t) of dlam dt.
//   ssd_bwd_q_kernel      per (b, h, chunk > 0): Q_c.
//   ssd_bwd_pass_kernel   per (b, h), elementwise over N x P, the chunks
//                         in reverse: G_c over Q_c in place.
//   ssd_bwd_intra_kernel  per (b, h, chunk): DY, W and M in shared memory,
//                         the intra part of dcs, sum_l M dy (into dx),
//                         W B and W^T C (per-head dC and dB).
//   ssd_bwd_inter_kernel  per (b, h, chunk): the G_c and S_in terms, dx,
//                         ddt, and the chunk's part of dA.
//   ssd_bwd_sum_kernel    dB and dC summed over the heads, dA over the
//                         batch and the chunks.
// Every sum runs in a fixed order (no atomics): two calls give the same
// bits, which a bit-exact restart of training needs.  A thread of a
// product owns rows ty + 16 i and columns tx + 16 j of its output; the
// tiles sit in shared memory at odd row strides.  P is at most 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int MAX_L = 128;     // chunk length, at most
constexpr int MAX_N = 128;     // state size, at most
constexpr int PW = 64;         // columns of P per block (passes 2 and 4)
constexpr int LDP = PW + 4;    // row stride of the (., PW) tiles
constexpr int LD = MAX_L + 4;  // row stride of the (., L) and (., N) tiles
constexpr int PASS_NT = 256;   // threads per block of ssd_pass_kernel
constexpr int PASS_EL = 4;     // elements per thread of ssd_pass_kernel

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

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
}

// acc[i][j] = fma(a[i], b[j], acc[i][j]): one step of the in-order sums.
template <int C>
__device__ __forceinline__ void outer(float (&acc)[4][C], const float4 a,
                                      const float (&b)[C]) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = __fmaf_rn(av[i], b[j], acc[i][j]);
}

// outer() against a thread's eight columns of the row at p: q..q+3 and
// 32+q..32+q+3 (p points at q; q = 4 * (tid % 8)), so that eight threads
// read (and write) 128 contiguous bytes of a row.
__device__ __forceinline__ void outer8(float (&acc)[4][8], const float4 a,
                                       const float* p) {
  const float4 u = ld4(p), v = ld4(p + 32);
  const float b[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
  outer(acc, a, b);
}

// Columns q..q+3 of a row (v[0..3]), 16 bytes (8 for bfloat16) at once
// where `vec` and all four lie before Pw.
__device__ __forceinline__ void put4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
template <typename T>
__device__ __forceinline__ void put_row(T* row, int q, int Pw, bool vec,
                                        const float* v) {
  if (vec && q + 3 < Pw) {
    put4(row + q, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (q + j < Pw) put(row + q + j, v[j]);
}

// ---- staging: every copy of a tile in flight at once ---------------------
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Rows r < R, columns p < cols of src (row stride rs) into tile[r*ld + p]
// with cp.async, zeros up to row Rp and column W (a multiple of 4); each
// thread copies the groups of 4 columns e = 4 * (tid + k * NT) (see
// scale_rows).  16-byte copies where the rows allow them.
__device__ __forceinline__ void cp_tile(float* tile, int ld, const float* src,
                                        long long rs, int R, int Rp, int cols,
                                        int W) {
  const bool vec = cols % 4 == 0 && rs % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int e = 4 * threadIdx.x; e < Rp * W; e += 4 * NT) {
    const int r = e / W, p = e - r * W;
    float* d = tile + r * ld + p;
    const float* q = src + r * rs + p;
    if (vec && r < R && p < cols) {
      cp16(d, q);
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (r < R && p + j < cols)
        cp4(d + j, q + j);
      else
        d[j] = 0.f;
    }
  }
}

// The same from bfloat16, widened, with plain loads.
__device__ __forceinline__ void cp_tile(float* tile, int ld,
                                        const __nv_bfloat16* src, long long rs,
                                        int R, int Rp, int cols, int W) {
  for (int e = 4 * threadIdx.x; e < Rp * W; e += 4 * NT) {
    const int r = e / W, p = e - r * W;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tile[r * ld + p + j] =
          (r < R && p + j < cols) ? widen(src[r * rs + p + j]) : 0.f;
  }
}

// tile[r*ld + p] = f[r] * tile[r*ld + p] (dt*x, the plain version's
// operation) over this thread's groups of cp_tile.
__device__ __forceinline__ void scale_rows(float* tile, int ld, const float* f,
                                           int Rp, int W) {
  for (int e = 4 * threadIdx.x; e < Rp * W; e += 4 * NT) {
    const int r = e / W;
    float* q = tile + r * ld + e - r * W;
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = f[r] * q[j];
  }
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
  float* cbt;       // scratch (B, nc, L, L): (C B^T)^T where m <= l
  float* ct;        // scratch (B, nc, N, L): C^T
  float* cs;        // scratch (B, H, nc, L): cs
  float* st;        // scratch (B, H, nc, N, P): S_c, then S_in
  int Bb, T, H, P, N, L;
};

namespace {

// One block's item of passes 2 and 4: (b, chunk, 64 columns of P, head).
struct Item {
  int c, h, p0, Pw;
  long long row0;  // b * T + c * L
  size_t bc;       // b * nc + c
  size_t bhc;      // (b * H + h) * nc + c
};

__device__ __forceinline__ Item item(const SsdArgs& a) {
  const int ps = (a.P + PW - 1) / PW, nc = a.T / a.L, b = blockIdx.z;
  Item it;
  it.c = blockIdx.x / ps;
  it.p0 = (blockIdx.x - it.c * ps) * PW;
  it.Pw = min(PW, a.P - it.p0);
  it.h = blockIdx.y;
  it.row0 = (long long)b * a.T + (long long)it.c * a.L;
  it.bc = (size_t)b * nc + it.c;
  it.bhc = ((size_t)b * a.H + it.h) * nc + it.c;
  return it;
}

// x for columns p0.. of the item's head and rows into dst[l*LDP + p],
// zero past L and P (float32 with cp.async: cp_wait, then scale_rows).
template <typename TX>
__device__ __forceinline__ void stage_x(const SsdArgs& a, const Item& it,
                                        float* dst) {
  cp_tile(dst, LDP,
          static_cast<const TX*>(a.x) + (it.row0 * a.H + it.h) * a.P + it.p0,
          (long long)a.H * a.P, a.L, MAX_L, it.Pw, PW);
}

// ---- 1. C B^T per (b, chunk), transposed, and C^T -----------------------
constexpr size_t CB_SMEM = sizeof(float) * 2 * MAX_N * LD;

template <typename TBC>
__global__ void __launch_bounds__(NT, 1) ssd_cb_kernel(const SsdArgs a) {
  extern __shared__ float smem[];
  float* ct = smem;             // C^T: ct[n*LD + l]
  float* bt = ct + MAX_N * LD;  // B^T: bt[n*LD + l]
  const int N = a.N, L = a.L, nc = a.T / L, tid = threadIdx.x;
  const size_t bc = (size_t)blockIdx.y * nc + blockIdx.x;
  const long long row0 = (long long)bc * L;  // b * T + c * L
  const TBC* Bm = static_cast<const TBC*>(a.Bm);
  const TBC* Cm = static_cast<const TBC*>(a.Cm);
  for (int e = tid; e < N * MAX_L; e += NT) {
    const int l = e / N, n = e - l * N;
    const bool in = l < L;
    ct[n * LD + l] = in ? widen(Cm[(row0 + l) * N + n]) : 0.f;
    bt[n * LD + l] = in ? widen(Bm[(row0 + l) * N + n]) : 0.f;
  }
  __syncthreads();
  float* gct = a.ct + bc * N * L;
  for (int e = tid; e < N * L; e += NT) {
    const int n = e / L;
    gct[e] = ct[n * LD + e - n * L];
  }

  // C B^T[l][m] = sum_n C[l][n] B[m][n], in order over n: three 4x4
  // patches a thread, rows {r, 64 + r} and columns {m, 64 + m} (the patch
  // of rows < 64 and columns >= 64 lies above the diagonal)
  const int cr = 4 * (tid >> 4), cm = 4 * (tid & 15);
  const bool hi = L > 64;
  float ll[4][4], hl[4][4], hh[4][4];
  zero(ll);
  zero(hl);
  zero(hh);
  for (int n = 0; n < N; ++n) {
    const float4 rl = ld4(ct + n * LD + cr), q = ld4(bt + n * LD + cm);
    const float ql[4] = {q.x, q.y, q.z, q.w};
    outer(ll, rl, ql);
    if (hi) {
      const float4 rh = ld4(ct + n * LD + 64 + cr);
      const float4 u = ld4(bt + n * LD + 64 + cm);
      const float qh[4] = {u.x, u.y, u.z, u.w};
      outer(hl, rh, ql);
      outer(hh, rh, qh);
    }
  }
  // (C B^T)^T[m][l] for m <= l < L
  float* cbt = a.cbt + bc * L * L;
  auto emit = [&](const float (&cb)[4][4], int r0, int m0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = r0 + i, m = m0 + j;
        if (l < L && m <= l) cbt[m * L + l] = cb[i][j];
      }
  };
  emit(ll, cr, cm);
  if (hi) {
    emit(hl, 64 + cr, cm);
    emit(hh, 64 + cr, 64 + cm);
  }
}

// ---- 2. cs and each chunk's own state S_c, per (b, h, chunk, slice) -----
constexpr size_t STATE_SMEM =
    sizeof(float) * (3 * MAX_L + MAX_L * LD + MAX_L * LDP);

template <typename TX, typename TBC>
__global__ void __launch_bounds__(NT, 2) ssd_state_kernel(const SsdArgs a) {
  extern __shared__ float smem[];
  float* dts = smem;             // dt
  float* css = dts + MAX_L;      // cs
  float* ws = css + MAX_L;       // exp(cs_L - cs)
  float* bm = ws + MAX_L;        // B, then B o w: bm[l*LD + n]
  float* dtx = bm + MAX_L * LD;  // dt*x: dtx[l*LDP + p]
  const Item it = item(a);
  const int N = a.N, L = a.L, H = a.H, P = a.P, h = it.h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_x<TX>(a, it, dtx);
  cp_tile(bm, LD, static_cast<const TBC*>(a.Bm) + it.row0 * N, N, L, L, N,
          (N + 3) & ~3);
  if (tid < MAX_L) dts[tid] = tid < L ? a.dt[(it.row0 + tid) * H + h] : 0.f;
  __syncthreads();
  if (warp == 0) {  // while the copies are in flight
    if (lane == 0) {
      // in order, one step after the other, as torch.cumsum sums
      const float A_h = a.A[h];
      float run = 0.f;  // dt is 0 past L: the sum stays put there
      for (int l = 0; l < MAX_L; l += 4) {
        const float4 d = ld4(dts + l);
        float4 o;
        o.x = run += d.x * A_h;
        o.y = run += d.y * A_h;
        o.z = run += d.z * A_h;
        o.w = run += d.w * A_h;
        *reinterpret_cast<float4*>(css + l) = o;
      }
    }
    __syncwarp();
    const float cl = css[L - 1];
    for (int l = lane; l < L; l += 32) {
      ws[l] = expf(cl - css[l]);
      if (it.p0 == 0) a.cs[it.bhc * L + l] = css[l];
    }
  }
  cp_wait();
  scale_rows(dtx, LDP, dts, MAX_L, PW);
  __syncthreads();
  scale_rows(bm, LD, ws, L, (N + 3) & ~3);  // B o w, once for the block
  __syncthreads();

  // S_c[n][p] = sum_l (B[l][n] w[l]) dtx[l][p], in order over l: a thread
  // has rows n0..n0+3 and the columns of outer8 at q0
  const int n0 = 4 * (tid >> 3), q0 = 4 * (tid & 7);
  if (n0 >= N) return;
  float acc[4][8];
  zero(acc);
  for (int l = 0; l < L; ++l)
    outer8(acc, ld4(bm + l * LD + n0), dtx + l * LDP + q0);
  float* out = a.st + it.bhc * N * P + it.p0;
  const bool vec = P % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (n0 + i >= N) break;
    put_row(out + (size_t)(n0 + i) * P, q0, it.Pw, vec, acc[i]);
    put_row(out + (size_t)(n0 + i) * P, q0 + 32, it.Pw, vec, acc[i] + 4);
  }
}

// ---- 3. state passing, per (b, h), elementwise over N x P ---------------
__global__ void __launch_bounds__(PASS_NT) ssd_pass_kernel(const SsdArgs a) {
  const int H = a.H, L = a.L, nc = a.T / L, h = blockIdx.y, b = blockIdx.z;
  const size_t NP = (size_t)a.N * a.P;
  const size_t bh = (size_t)b * H + h;
  float* s = a.st + bh * nc * NP;
  const float* cs = a.cs + bh * nc * L;
  const size_t e0 = (size_t)blockIdx.x * PASS_NT * PASS_EL + threadIdx.x;
  float state[PASS_EL], cur[PASS_EL];
#pragma unroll
  for (int j = 0; j < PASS_EL; ++j) {
    const size_t e = e0 + j * PASS_NT;
    state[j] = 0.f;
    cur[j] = e < NP ? s[e] : 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    const float eL = expf(cs[(size_t)c * L + L - 1]);
    float* sc = s + c * NP;
#pragma unroll
    for (int j = 0; j < PASS_EL; ++j) {
      const size_t e = e0 + j * PASS_NT;
      if (e >= NP) continue;
      const float nxt = c + 1 < nc ? sc[NP + e] : 0.f;
      sc[e] = state[j];
      state[j] = eL * state[j] + cur[j];
      cur[j] = nxt;
    }
  }
#pragma unroll
  for (int j = 0; j < PASS_EL; ++j) {
    const size_t e = e0 + j * PASS_NT;
    if (e < NP) a.state[bh * NP + e] = state[j];
  }
}

// ---- 4. y per (b, h, chunk, slice) --------------------------------------
// One tile holds C^T for y_inter, then the decayed (C B^T)^T; the other
// S_in, then dt*x.
constexpr size_t OUT_SMEM =
    sizeof(float) * (2 * MAX_L + MAX_N * LD + MAX_N * LDP);

template <typename TX>
__global__ void __launch_bounds__(NT, 2) ssd_out_kernel(const SsdArgs a) {
  static_assert(MAX_N == MAX_L, "the tiles hold either");
  extern __shared__ float smem[];
  float* dts = smem;            // dt
  float* css = dts + MAX_L;     // cs
  float* as = css + MAX_L;      // C^T[n][l], then P^T[m][l]
  float* bs = as + MAX_N * LD;  // S_in[n][p], then dt*x[m][p]
  const Item it = item(a);
  const int N = a.N, L = a.L, H = a.H, P = a.P, h = it.h;
  const int tid = threadIdx.x, warp = tid >> 5;
  // a thread sums rows l0..l0+3 and the columns of outer8 at q0 of y
  const int l0 = 4 * (tid >> 3), q0 = 4 * (tid & 7);
  const bool live = l0 < L;

  if (tid < MAX_L) {
    dts[tid] = tid < L ? a.dt[(it.row0 + tid) * H + h] : 0.f;
    css[tid] = tid < L ? a.cs[it.bhc * L + tid] : 0.f;
  }
  // ---- y_inter = exp(cs) o (C @ S_in); the state is 0 in chunk 0 --------
  float yi[4][8];
  zero(yi);
  if (it.c > 0) {
    cp_tile(as, LD, a.ct + it.bc * N * L, L, N, N, L, (L + 3) & ~3);
    cp_tile(bs, LDP, a.st + it.bhc * N * P + it.p0, P, N, N, it.Pw, PW);
    cp_wait();
    __syncthreads();
    if (live) {
      for (int n = 0; n < N; ++n)
        outer8(yi, ld4(as + n * LD + l0), bs + n * LDP + q0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(css[l0 + i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) yi[i][j] = yi[i][j] * e;
      }
    }
  }
  __syncthreads();  // every read of C^T and S_in is done; dt and cs are in
  // ---- y_intra = (C B^T o decay) @ dtx ----------------------------------
  stage_x<TX>(a, it, bs);
  // P^T[m][l] = C B^T[l][m] * exp(cs_l - cs_m) for m <= l < L, else 0:
  // the masked exponential, so no inf reaches a product
  const float* cbt = a.cbt + it.bc * L * L;
  for (int e = tid; e < L * L; e += NT) {
    const int m = e / L, l = e - m * L;
    as[m * LD + l] = m <= l ? cbt[e] * expf(css[l] - css[m]) : 0.f;
  }
  cp_wait();
  scale_rows(bs, LDP, dts, MAX_L, PW);
  __syncthreads();
  if (!live) return;
  float ya[4][8];
  zero(ya);
  const int m_end = min(L, 16 * warp + 16);  // P is 0 past the warp's rows
  for (int m = 0; m < m_end; ++m)
    outer8(ya, ld4(as + m * LD + l0), bs + m * LDP + q0);
  TX* y = static_cast<TX*>(a.y) + (it.row0 * H + h) * P + it.p0;
  const bool vec = P % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & (4 * sizeof(TX) - 1)) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (l0 + i >= L) break;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = ya[i][j] + yi[i][j];
    TX* row = y + (long long)(l0 + i) * H * P;
    put_row(row, q0, it.Pw, vec, v);
    put_row(row, q0 + 32, it.Pw, vec, v + 4);
  }
}

template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TX, typename TBC>
int launch(const SsdArgs& a, cudaStream_t stream) {
  static int opted = -1;  // above 48 KB only after an opt-in, once
  if (opted != 0) {
    opted = opt_in(ssd_cb_kernel<TBC>, CB_SMEM);
    if (!opted) opted = opt_in(ssd_state_kernel<TX, TBC>, STATE_SMEM);
    if (!opted) opted = opt_in(ssd_out_kernel<TX>, OUT_SMEM);
    if (opted) return opted;
  }
  const int nc = a.T / a.L, ps = (a.P + PW - 1) / PW;
  const long long np = (long long)a.N * a.P;
  int err;
  ssd_cb_kernel<TBC><<<dim3(nc, a.Bb), NT, CB_SMEM, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_state_kernel<TX, TBC>
      <<<dim3(nc * ps, a.H, a.Bb), NT, STATE_SMEM, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const int nb = (int)((np + PASS_NT * PASS_EL - 1) / (PASS_NT * PASS_EL));
  ssd_pass_kernel<<<dim3(nb, a.H, a.Bb), PASS_NT, 0, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_out_kernel<TX><<<dim3(nc * ps, a.H, a.Bb), NT, OUT_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- backward -------------------------------------------------------------

constexpr int MAX_PB = 64;       // P, at most, in the backward
constexpr int LDL = MAX_L + 1;   // row stride of (., L) and (., N) tiles
constexpr int LDQ = MAX_PB + 1;  // row stride of (., P) tiles

}  // namespace

// Mirrored field for field by SsdBwdArgs in kernels/ssd_scan.py.
struct SsdBwdArgs {
  const float* x;       // (B,T,H,P)
  const float* dt;      // (B,T,H)
  const float* A;       // (H,)
  const float* Bm;      // (B,T,N)
  const float* Cm;      // (B,T,N)
  const float* dy;      // (B,T,H,P)
  const float* dfinal;  // (B,H,N,P), or null: the final state's gradient
  const float* cbt;     // the forward's scratch (B, nc, L, L)
  const float* cs;      // the forward's scratch (B, H, nc, L)
  const float* st;      // the forward's scratch (B, H, nc, N, P): S_in
  float* dx;            // (B,T,H,P): sum_l M dy first, then dx
  float* ddt;           // (B,T,H)
  float* dA;            // (H,)
  float* dB;            // (B,T,N)
  float* dC;            // (B,T,N)
  float* gs;            // scratch (B, H, nc, N, P): Q_c, then G_c
  float* dcs;           // scratch (B, H, nc, L): the intra part of dcs
  float* dBh;           // scratch (B, H, T, N): dB of each head
  float* dCh;           // scratch (B, H, T, N): dC of each head
  float* dAp;           // scratch (B, H, nc): dA of each (b, h, chunk)
  int Bb, T, H, P, N, L;
};

namespace {

// dst[r*ld + c] = src[r*rs + c] for r < R, c < C; 0 elsewhere up to
// (Rp, Cp).
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long rs, int R, int C, int Rp,
                                      int Cp) {
  for (int e = threadIdx.x; e < Rp * Cp; e += NT) {
    const int r = e / Cp, c = e - r * Cp;
    dst[r * ld + c] = (r < R && c < C) ? src[r * rs + c] : 0.f;
  }
}

// acc[i][j] += sum_{k < K} A[i*16*ar + k*ak] * Bm[k*bk + j*16*bc], in
// order over k; A and Bm already point at the thread's row ty and column
// tx.
template <int RI, int CJ>
__device__ __forceinline__ void mm(float (&acc)[RI][CJ], const float* A,
                                   int ar, int ak, const float* Bm, int bk,
                                   int bc, int K) {
  for (int k = 0; k < K; ++k) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A[i * 16 * ar + k * ak];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = Bm[k * bk + j * 16 * bc];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }
}

// One block's (b, h, chunk) of the backward: blockIdx (chunk, h, b).
struct BItem {
  int b, h, c, nc;
  long long row0;  // b * T + c * L
  size_t bc;       // b * nc + c
  size_t bhc;      // (b * H + h) * nc + c
};

__device__ __forceinline__ BItem bitem(const SsdBwdArgs& a, int c) {
  BItem it;
  it.nc = a.T / a.L;
  it.b = blockIdx.z;
  it.h = blockIdx.y;
  it.c = c;
  it.row0 = (long long)it.b * a.T + (long long)c * a.L;
  it.bc = (size_t)it.b * it.nc + c;
  it.bhc = ((size_t)it.b * a.H + it.h) * it.nc + c;
  return it;
}

// ---- b1. Q_c = sum_l exp(cs_l) C_l (x) dy_l, chunks 1.. ------------------
constexpr size_t BQ_SMEM = sizeof(float) * (MAX_L * LDL + MAX_L * LDQ + MAX_L);

__global__ void __launch_bounds__(NT, 1) ssd_bwd_q_kernel(const SsdBwdArgs a) {
  extern __shared__ float smem[];
  float* cm = smem;               // C o exp(cs): cm[l*LDL + n]
  float* dys = cm + MAX_L * LDL;  // dy: dys[l*LDQ + p]
  float* css = dys + MAX_L * LDQ;
  const BItem it = bitem(a, blockIdx.x + 1);
  const int N = a.N, L = a.L, H = a.H, P = a.P, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  stage(cm, LDL, a.Cm + it.row0 * N, N, L, N, MAX_L, MAX_N);
  stage(dys, LDQ, a.dy + (it.row0 * H + it.h) * P, (long long)H * P, L, P,
        MAX_L, MAX_PB);
  if (tid < MAX_L) css[tid] = tid < L ? a.cs[it.bhc * L + tid] : 0.f;
  __syncthreads();
  for (int e = tid; e < L * MAX_N; e += NT) {
    const int l = e / MAX_N;
    cm[l * LDL + e - l * MAX_N] *= expf(css[l]);
  }
  __syncthreads();
  float acc[8][4];
  zero(acc);
  mm(acc, cm + ty, 1, LDL, dys + tx, LDQ, 1, L);
  float* q = a.gs + it.bhc * N * P;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = ty + 16 * i, p = tx + 16 * j;
      if (n < N && p < P) q[n * P + p] = acc[i][j];
    }
}

// ---- b2. G_c, the chunks in reverse, per (b, h) --------------------------
// As ssd_pass_kernel, backwards: a thread's PASS_EL elements step
// together, each chunk's Q_c read before its slot takes G_c.
__global__ void __launch_bounds__(PASS_NT) ssd_bwd_pass_kernel(
    const SsdBwdArgs a) {
  const int L = a.L, nc = a.T / L;
  const size_t NP = (size_t)a.N * a.P;
  const size_t bh = (size_t)blockIdx.z * a.H + blockIdx.y;
  float* g = a.gs + bh * nc * NP;
  const float* cs = a.cs + bh * nc * L;
  const size_t e0 = (size_t)blockIdx.x * PASS_NT * PASS_EL + threadIdx.x;
  float cur[PASS_EL], q[PASS_EL];
#pragma unroll
  for (int j = 0; j < PASS_EL; ++j) {
    const size_t e = e0 + j * PASS_NT;
    cur[j] = (e < NP && a.dfinal) ? a.dfinal[bh * NP + e] : 0.f;
    q[j] = (e < NP && nc > 1) ? g[(nc - 1) * NP + e] : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const float eL = expf(cs[(size_t)c * L + L - 1]);
    float* gc = g + c * NP;
#pragma unroll
    for (int j = 0; j < PASS_EL; ++j) {
      const size_t e = e0 + j * PASS_NT;
      if (e >= NP) continue;
      const float nxt = c > 1 ? gc[e - NP] : 0.f;  // Q_{c-1}
      gc[e] = cur[j];                               // G_c
      cur[j] = eL * cur[j] + q[j];                  // G_{c-1}
      q[j] = nxt;
    }
  }
}

// ---- b3. the intra-chunk terms, per (b, h, chunk) ------------------------
constexpr size_t BI_SMEM =
    sizeof(float) * (2 * MAX_L * LDL + 2 * MAX_L * LDQ + 2 * MAX_L +
                     2 * 16 * MAX_L);

__global__ void __launch_bounds__(NT, 1) ssd_bwd_intra_kernel(
    const SsdBwdArgs a) {
  extern __shared__ float smem[];
  float* W = smem;                 // W[l*LDL + m]
  float* M = W + MAX_L * LDL;      // M[l*LDL + m], then B, then C
  float* dys = M + MAX_L * LDL;    // dy[l*LDQ + p]
  float* dtxs = dys + MAX_L * LDQ; // dt*x[l*LDQ + p]
  float* dts = dtxs + MAX_L * LDQ;
  float* css = dts + MAX_L;
  float* rpart = css + MAX_L;      // rpart[tx*MAX_L + l]: E's row sums
  float* cpart = rpart + 16 * MAX_L;  // cpart[ty*MAX_L + m]: column sums
  const BItem it = bitem(a, blockIdx.x);
  const int N = a.N, L = a.L, H = a.H, P = a.P, T = a.T, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long hp = (long long)H * P;
  stage(dys, LDQ, a.dy + (it.row0 * H + it.h) * P, hp, L, P, MAX_L, MAX_PB);
  stage(dtxs, LDQ, a.x + (it.row0 * H + it.h) * P, hp, L, P, MAX_L, MAX_PB);
  if (tid < MAX_L) {
    dts[tid] = tid < L ? a.dt[(it.row0 + tid) * H + it.h] : 0.f;
    css[tid] = tid < L ? a.cs[it.bhc * L + tid] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < MAX_L * MAX_PB; e += NT) {
    const int l = e / MAX_PB;
    float* q = dtxs + l * LDQ + e - l * MAX_PB;
    *q = dts[l] * *q;
  }
  __syncthreads();

  // DY[l][m] = dy_l . dtx_m; then W, M and E's row and column sums
  {
    float acc[8][8];
    zero(acc);
    mm(acc, dys + ty * LDQ, LDQ, 1, dtxs + tx * LDQ, 1, LDQ, P);
    const float* cbt = a.cbt + it.bc * L * L;
    float rs[8], cs_[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) rs[i] = cs_[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int l = ty + 16 * i, m = tx + 16 * j;
        const bool live = l < L && m <= l;
        const float d = live ? expf(css[l] - css[m]) : 0.f;
        const float cb = live ? cbt[m * L + l] : 0.f;
        const float w = acc[i][j] * d;
        const float e = w * cb;
        W[l * LDL + m] = w;
        M[l * LDL + m] = cb * d;
        rs[i] += e;
        cs_[j] += e;
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rpart[tx * MAX_L + ty + 16 * i] = rs[i];
      cpart[ty * MAX_L + tx + 16 * i] = cs_[i];
    }
  }
  __syncthreads();
  if (tid < L) {
    float v = 0.f;
    for (int t = 0; t < 16; ++t) v += rpart[t * MAX_L + tid];
    for (int t = 0; t < 16; ++t) v -= cpart[t * MAX_L + tid];
    a.dcs[it.bhc * L + tid] = v;
  }
  // sum_l M[l][m] dy_l into dx (the inter kernel adds the rest)
  {
    float acc[8][4];
    zero(acc);
    mm(acc, M + ty, 1, LDL, dys + tx, LDQ, 1, L);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = ty + 16 * i, p = tx + 16 * j;
        if (m < L && p < P) a.dx[(it.row0 + m) * hp + it.h * P + p] = acc[i][j];
      }
  }
  __syncthreads();
  float* out_h = nullptr;
  const size_t hrow = ((size_t)it.b * H + it.h) * T + (size_t)it.c * L;
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0: dC_l = sum_m W[l][m] B_m;  pass 1: dB_m = sum_l W[l][m] C_l
    stage(M, LDL, (pass ? a.Cm : a.Bm) + it.row0 * N, N, L, N, MAX_L, MAX_N);
    __syncthreads();
    float acc[8][8];
    zero(acc);
    if (pass == 0)
      mm(acc, W + ty * LDL, LDL, 1, M + tx, LDL, 1, L);
    else
      mm(acc, W + ty, 1, LDL, M + tx, LDL, 1, L);
    out_h = (pass ? a.dBh : a.dCh) + hrow * N;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = ty + 16 * i, n = tx + 16 * j;
        if (r < L && n < N) out_h[(size_t)r * N + n] = acc[i][j];
      }
    __syncthreads();
  }
}

// ---- b4. the carried-state terms, dx, ddt and dA, per (b, h, chunk) ------
constexpr size_t BX_SMEM =
    sizeof(float) * (MAX_L * LDL + 4 * MAX_L * LDQ + 5 * MAX_L +
                     3 * 16 * MAX_L + NT);

__global__ void __launch_bounds__(NT, 1) ssd_bwd_inter_kernel(
    const SsdBwdArgs a) {
  static_assert(MAX_N == MAX_L, "the (., N) and (., L) tiles share strides");
  extern __shared__ float smem[];
  float* Bs = smem;                  // B[m*LDL + n]
  float* Gs = Bs + MAX_L * LDL;      // G_c[n*LDQ + p]
  float* Ss = Gs + MAX_N * LDQ;      // S_in[n*LDQ + p]
  float* dys = Ss + MAX_N * LDQ;     // dy[l*LDQ + p]
  float* dtxs = dys + MAX_L * LDQ;   // dt*x[l*LDQ + p]
  float* dts = dtxs + MAX_L * LDQ;
  float* css = dts + MAX_L;
  float* dcs = css + MAX_L;          // dcs, then dlam
  float* xd = dcs + MAX_L;           // ddtx . x
  float* uu = xd + MAX_L;            // u
  float* up = uu + MAX_L;            // up[tx*MAX_L + m]: parts of u
  float* xp = up + 16 * MAX_L;       // parts of ddtx . x
  float* cp = xp + 16 * MAX_L;       // parts of C_l . dC2_l
  float* red = cp + 16 * MAX_L;      // <G_c, S_in> by thread
  const BItem it = bitem(a, blockIdx.x);
  const int N = a.N, L = a.L, H = a.H, P = a.P, T = a.T, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long hp = (long long)H * P;
  const size_t np = (size_t)N * P;
  stage(Bs, LDL, a.Bm + it.row0 * N, N, L, N, MAX_L, MAX_N);
  stage(Gs, LDQ, a.gs + it.bhc * np, P, N, P, MAX_N, MAX_PB);
  stage(Ss, LDQ, a.st + it.bhc * np, P, N, P, MAX_N, MAX_PB);
  stage(dys, LDQ, a.dy + (it.row0 * H + it.h) * P, hp, L, P, MAX_L, MAX_PB);
  stage(dtxs, LDQ, a.x + (it.row0 * H + it.h) * P, hp, L, P, MAX_L, MAX_PB);
  if (tid < MAX_L) {
    dts[tid] = tid < L ? a.dt[(it.row0 + tid) * H + it.h] : 0.f;
    css[tid] = tid < L ? a.cs[it.bhc * L + tid] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < MAX_L * MAX_PB; e += NT) {
    const int l = e / MAX_PB;
    float* q = dtxs + l * LDQ + e - l * MAX_PB;
    *q = dts[l] * *q;
  }
  __syncthreads();
  const float cl = css[L - 1];

  // ddtx = (sum_l M dy, from the intra kernel) + w_m B_m G_c; dx; u; ddtx.x
  {
    float acc[8][4];
    zero(acc);
    mm(acc, Bs + ty * LDL, LDL, 1, Gs + tx, LDQ, 1, N);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty + 16 * i;
      const bool in = m < L;
      const float w = in ? expf(cl - css[m]) : 0.f;
      float us = 0.f, xs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (!in || p >= P) continue;
        const float v = acc[i][j] * w;
        us += v * dtxs[m * LDQ + p];
        const long long o = (it.row0 + m) * hp + it.h * P + p;
        const float dd = a.dx[o] + v;
        xs += dd * a.x[o];
        a.dx[o] = dts[m] * dd;
      }
      up[tx * MAX_L + m] = us;
      xp[tx * MAX_L + m] = xs;
    }
  }
  const size_t hrow = ((size_t)it.b * H + it.h) * T + (size_t)it.c * L;
  // dB_m += w_m G_c dtx_m
  {
    float acc[8][8];
    zero(acc);
    mm(acc, dtxs + ty * LDQ, LDQ, 1, Gs + tx * LDQ, 1, LDQ, P);
    float* dbh = a.dBh + hrow * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty + 16 * i;
      if (m >= L) continue;
      const float w = expf(cl - css[m]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) dbh[(size_t)m * N + n] += acc[i][j] * w;
      }
    }
  }
  // dC_l += exp(cs_l) S_in dy_l;  C_l . that, for dcs
  {
    float acc[8][8];
    zero(acc);
    mm(acc, dys + ty * LDQ, LDQ, 1, Ss + tx * LDQ, 1, LDQ, P);
    float* dch = a.dCh + hrow * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int l = ty + 16 * i;
      float s = 0.f;
      if (l < L) {
        const float e = expf(css[l]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n >= N) continue;
          const float v = acc[i][j] * e;
          dch[(size_t)l * N + n] += v;
          s += v * a.Cm[(it.row0 + l) * N + n];
        }
      }
      cp[tx * MAX_L + l] = s;
    }
  }
  // <G_c, S_in>, by thread
  {
    float s = 0.f;
    for (int e = tid; e < N * P; e += NT) {
      const int n = e / P, p = e - n * P;
      s += Gs[n * LDQ + p] * Ss[n * LDQ + p];
    }
    red[tid] = s;
  }
  __syncthreads();
  if (tid < L) {
    float u = 0.f, x = 0.f, c = 0.f;
    for (int t = 0; t < 16; ++t) u += up[t * MAX_L + tid];
    for (int t = 0; t < 16; ++t) x += xp[t * MAX_L + tid];
    for (int t = 0; t < 16; ++t) c += cp[t * MAX_L + tid];
    uu[tid] = u;
    xd[tid] = x;
    dcs[tid] = a.dcs[it.bhc * L + tid] + c - u;
  }
  __syncthreads();
  if (tid == 0) {
    float gs = 0.f, us = 0.f;
    for (int t = 0; t < NT; ++t) gs += red[t];
    for (int l = 0; l < L; ++l) us += uu[l];
    dcs[L - 1] += expf(cl) * gs + us;
    // dlam: the in-chunk reverse cumsum of dcs; dA's part in order.  In
    // double: dA sums B x T terms of both signs (the plain twin's float32
    // sums carry their own rounding, which the tolerance covers)
    double run = 0.0, da = 0.0;
    for (int l = L - 1; l >= 0; --l) {
      run += (double)dcs[l];
      dcs[l] = (float)run;
      da += run * (double)dts[l];
    }
    a.dAp[it.bhc] = (float)da;
  }
  __syncthreads();
  if (tid < L)
    a.ddt[(it.row0 + tid) * H + it.h] = dcs[tid] * a.A[it.h] + xd[tid];
}

// ---- b5. dB and dC over the heads, dA over (b, chunk), in order ----------
__global__ void __launch_bounds__(NT) ssd_bwd_sum_kernel(const SsdBwdArgs a) {
  const int H = a.H, nc = a.T / a.L;
  const size_t TN = (size_t)a.T * a.N, total = (size_t)a.Bb * TN;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < total;
       e += (size_t)gridDim.x * NT) {
    const size_t b = e / TN, r = e - b * TN;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const size_t o = ((size_t)b * H + h) * TN + r;
      sb += a.dBh[o];
      sc += a.dCh[o];
    }
    a.dB[e] = sb;
    a.dC[e] = sc;
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < H; h += NT) {
      double s = 0.0;
      for (int b = 0; b < a.Bb; ++b)
        for (int c = 0; c < nc; ++c) s += a.dAp[((size_t)b * H + h) * nc + c];
      a.dA[h] = (float)s;
    }
}

int launch_bwd(const SsdBwdArgs& a, cudaStream_t stream) {
  static int opted = -1;
  if (opted != 0) {
    opted = opt_in(ssd_bwd_q_kernel, BQ_SMEM);
    if (!opted) opted = opt_in(ssd_bwd_intra_kernel, BI_SMEM);
    if (!opted) opted = opt_in(ssd_bwd_inter_kernel, BX_SMEM);
    if (opted) return opted;
  }
  const int nc = a.T / a.L;
  const long long np = (long long)a.N * a.P;
  int err;
  if (nc > 1) {
    ssd_bwd_q_kernel<<<dim3(nc - 1, a.H, a.Bb), NT, BQ_SMEM, stream>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const int nb = (int)((np + PASS_NT * PASS_EL - 1) / (PASS_NT * PASS_EL));
  ssd_bwd_pass_kernel<<<dim3(nb, a.H, a.Bb), PASS_NT, 0, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_intra_kernel<<<dim3(nc, a.H, a.Bb), NT, BI_SMEM, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_inter_kernel<<<dim3(nc, a.H, a.Bb), NT, BX_SMEM, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const long long total = (long long)a.Bb * a.T * a.N;
  const int sb = (int)std::min<long long>((total + NT - 1) / NT, 4096);
  ssd_bwd_sum_kernel<<<sb, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Five launches on `stream` (four when T is one chunk); returns
// cudaGetLastError() after the first that fails, or after the last
// (cudaErrorInvalidValue for a shape the kernels do not take, before any
// launch).
extern "C" int ssd_scan_bwd(const SsdBwdArgs* a, cudaStream_t stream) {
  if (a->Bb < 1 || a->Bb > 65535 || a->H < 1 || a->H > 65535 || a->P < 1 ||
      a->P > MAX_PB || a->N < 1 || a->N > MAX_N || a->L < 1 ||
      a->L > MAX_L || a->T < 1 || a->T % a->L != 0 ||
      a->T / a->L > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return launch_bwd(*a, stream);
}

// x_bf16 / bc_bf16: 1 for bfloat16 x (and y) / B and C, 0 for float32.
// Four launches on `stream`; returns cudaGetLastError() after the first
// that fails, or after the last (cudaErrorInvalidValue for a shape the
// kernels do not take, before any launch).
extern "C" int ssd_scan(const SsdArgs* a, int x_bf16, int bc_bf16,
                        cudaStream_t stream) {
  if (a->Bb < 1 || a->Bb > 65535 || a->H < 1 || a->H > 65535 || a->P < 1 ||
      a->N < 1 || a->N > MAX_N || a->L < 1 || a->L > MAX_L || a->T < 1 ||
      a->T % a->L != 0 ||
      (long long)(a->T / a->L) * ((a->P + PW - 1) / PW) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (x_bf16 && bc_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(*a, stream);
  if (x_bf16) return launch<__nv_bfloat16, float>(*a, stream);
  if (bc_bf16) return launch<float, __nv_bfloat16>(*a, stream);
  return launch<float, float>(*a, stream);
}
