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
// B and C are shared across heads, so dB and dC sum over the heads: W is
// summed over them before its products with B and C, and each
// carried-state term is one product per (b, chunk) over K = H P (a row of
// dy or x at one (b, t) is contiguous over (h, p)).  No (B, H, T, N)
// partials.
//   ssd_bwd_q_kernel    per (b, h, chunk > 0): Q_c.
//   ssd_bwd_pass_kernel per (b, h), elementwise over N x P, the chunks in
//                       reverse: G_c over Q_c in place.
//   ssd_bwd_w_kernel    per (b, chunk, HEAD_GROUP heads), the heads in
//                       order: DY^T, W^T and E's sums above the diagonal
//                       (dcs's intra part), W^T summed in registers; the
//                       group's W^T, once (wg: 16.8 MB at mamba2's shape).
//   ssd_bwd_dx_kernel   per (b, h, chunk): w o (B G_c), then + M^T dy over
//                       the causal half: ddtx, dx, u, ddtx . x; C S_in for
//                       dcs's C_l . (exp(cs_l) S_in dy_l); dcs, dlam, ddt
//                       and the chunk's part of dA.
//   ssd_bwd_dbc_kernel  per (b, chunk, dB or dC, 32 columns of N): W^T
//                       summed over the groups in order and its product
//                       with C or B, then sum_h (w o dt o x_h) G_c,h^T or
//                       exp(cs) o dy_h S_in,h^T, the heads in order; each
//                       written once.  One block sums dA over (b, chunk).
// Every sum runs in a fixed order with no atomics (sums across lanes in
// fixed shuffle trees, then the warps' sums in warp order): two calls give
// the same bits, which a bit-exact restart of training needs.  Tiles come
// in with cp.async; products read float4s of shared memory, a thread's
// rows ty + 16 i (so that a warp's reads of rows whose k is contiguous
// meet no bank twice); each kernel but the pass fits two blocks an SM.
// Bound: float32 FMAs, 24.4 GFLOP at mamba2's layer shape (B 4, T 1024,
// H 80, P 64, N 128, L 128, nc 8), 0.364 ms at 67 TFLOP/s (chip_smoke.py
// ssd_bwd_timing: the causal halves of DY and M^T dy, W's two products
// once per (b, chunk), four L N P products a head).  The kernels'
// products at that shape, with no final state's gradient: 14.90 G FMAs,
//   q    (nc-1) B H L N P                                       2.349 G
//   w    nc B H (L (L+16) / 2) P  (16 x 16 tiles on and above
//        the diagonal)                                          1.510 G
//   dx   2 (nc-1) B H L N P (B G_c, C S_in)
//        + nc B H (L (L+16) / 2) P (M^T dy)                     6.208 G
//   dbc  2 nc B L L N (W's two, dense) + 2 (nc-1) B L N H P     4.832 G
// and 0.073 G of row factors in dbc.  C S_in for dcs is the L N P product
// a head beyond the bound; the diagonal tiles and W's dense products add
// the rest.
// P is at most 64.
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

constexpr int MAX_PB = PW;       // P, at most, in the backward
constexpr int HEAD_GROUP = 10;   // heads whose W one block of pass b3 sums
constexpr int DBC_COLS = 32;     // columns of N a block of pass b5 sums
constexpr int NWARP = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

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
  float* dx;            // (B,T,H,P)
  float* ddt;           // (B,T,H)
  float* dA;            // (H,)
  float* dB;            // (B,T,N)
  float* dC;            // (B,T,N)
  float* gs;            // scratch (B, H, nc, N, P): Q_c, then G_c
  float* dcs;           // scratch (B, H, nc, L): the intra part of dcs
  float* wg;            // scratch (B, nc, ng, L, L): W^T summed over a group
  float* dAp;           // scratch (B, H, nc): dA of each (b, h, chunk)
  int Bb, T, H, P, N, L;
};

namespace {

// acc[i][j] += sum_{k < K} A[i*16*lda + k] * B[j*16*ldb + k], in order over
// k (K a multiple of 4, float4 reads); A and B point at the thread's row ty
// and column tx.  UPPER: only j >= i (the rest lies below the diagonal).
template <int RI, int CJ, bool UPPER>
__device__ __forceinline__ void mm_nt(float (&acc)[RI][CJ], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
  for (int k = 0; k < K; k += 4) {
    float4 av[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = ld4(A + i * 16 * lda + k);
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const float4 b = ld4(B + j * 16 * ldb + k);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        if (UPPER && j < i) continue;
        float s = acc[i][j];
        s = __fmaf_rn(av[i].x, b.x, s);
        s = __fmaf_rn(av[i].y, b.y, s);
        s = __fmaf_rn(av[i].z, b.z, s);
        s = __fmaf_rn(av[i].w, b.w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][t] += sum_{k < K} A[i*16*lda + k] * B[k*ldb + t], in order over k
// (K a multiple of 4): A points at the thread's row ty (rows ty + 16 i),
// B at its four columns.  CAUSAL: row block i only from k = 16 i on (A is
// 0 below that).
template <int RI, bool CAUSAL>
__device__ __forceinline__ void mm_tn(float (&acc)[RI][4], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
  for (int k = 0; k < K; k += 4) {
    const int kb = k >> 4;
    float4 av[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      if (!CAUSAL || i <= kb) av[i] = ld4(A + i * 16 * lda + k);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 b = ld4(B + (k + t) * ldb);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        if (CAUSAL && i > kb) continue;
        const float x = t == 0 ? av[i].x
                        : t == 1 ? av[i].y
                        : t == 2 ? av[i].z
                                 : av[i].w;
        acc[i][0] = __fmaf_rn(x, b.x, acc[i][0]);
        acc[i][1] = __fmaf_rn(x, b.y, acc[i][1]);
        acc[i][2] = __fmaf_rn(x, b.z, acc[i][2]);
        acc[i][3] = __fmaf_rn(x, b.w, acc[i][3]);
      }
    }
  }
}

// The sum of v over a half-warp's 16 lanes in a fixed tree; every lane gets
// the same bits.
__device__ __forceinline__ float half_warp_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 8);
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 2);
  v += __shfl_xor_sync(FULL, v, 1);
  return v;
}

// The sum of v over the block: each warp's lanes in a fixed tree, then the
// warps' sums in warp order (red: NWARP slots of shared memory).  Every
// thread calls it and gets the same bits.
template <typename F>
__device__ __forceinline__ F block_sum(F v, F* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  F s = red[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) s += red[w];
  return s;
}

// Columns p0..p0+3 of a row of P (0 past P), 16 bytes at once where `vec`.
__device__ __forceinline__ void get4(float (&v)[4], const float* row, int p0,
                                     int P, bool vec) {
  if (vec && p0 + 3 < P) {
    const float4 u = ld4(row + p0);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = p0 + t < P ? row[p0 + t] : 0.f;
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
// As ssd_state_kernel: a thread sums rows n0..n0+3 of Q and the columns of
// outer8 at q0, in order over l.
constexpr size_t BQ_SMEM = sizeof(float) * (MAX_L + MAX_L * LD + MAX_L * LDP);

__global__ void __launch_bounds__(NT, 2) ssd_bwd_q_kernel(const SsdBwdArgs a) {
  extern __shared__ float smem[];
  float* es = smem;              // exp(cs)
  float* cm = es + MAX_L;        // C, then C o exp(cs): cm[l*LD + n]
  float* dys = cm + MAX_L * LD;  // dy: dys[l*LDP + p]
  const BItem it = bitem(a, blockIdx.x + 1);
  const int N = a.N, L = a.L, H = a.H, P = a.P, tid = threadIdx.x;
  const int N4 = (N + 3) & ~3;
  cp_tile(dys, LDP, a.dy + (it.row0 * H + it.h) * P, (long long)H * P, L, L,
          P, PW);
  cp_tile(cm, LD, a.Cm + it.row0 * N, N, L, L, N, N4);
  if (tid < L) es[tid] = expf(a.cs[it.bhc * L + tid]);
  cp_wait();
  __syncthreads();
  scale_rows(cm, LD, es, L, N4);
  __syncthreads();
  const int n0 = 4 * (tid >> 3), q0 = 4 * (tid & 7);
  if (n0 >= N) return;
  float acc[4][8];
  zero(acc);
  for (int l = 0; l < L; ++l)
    outer8(acc, ld4(cm + l * LD + n0), dys + l * LDP + q0);
  float* q = a.gs + it.bhc * N * P;
  const bool vec = P % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (n0 + i >= N) break;
    put_row(q + (size_t)(n0 + i) * P, q0, P, vec, acc[i]);
    put_row(q + (size_t)(n0 + i) * P, q0 + 32, P, vec, acc[i] + 4);
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

// ---- b3. W summed over a group of heads; dcs's intra part ----------------
// Per (b, chunk, group of HEAD_GROUP heads), the heads in order: DY^T =
// dtx dy^T above the diagonal (a thread's rows m = ty + 16 i, columns
// l = tx + 16 j, j >= i), W^T = DY^T o D^T summed into registers, E's row
// and column sums (a half-warp's shuffles; the warps' parts in order) into
// dcs; at the end the group's W^T, once.
constexpr size_t BW_SMEM =
    sizeof(float) * (2 * MAX_L * LDP + 3 * MAX_L + NWARP * MAX_L);

__global__ void __launch_bounds__(NT, 2) ssd_bwd_w_kernel(const SsdBwdArgs a) {
  extern __shared__ float smem[];
  float* dys = smem;               // dy[l*LDP + p]
  float* dtx = dys + MAX_L * LDP;  // dt*x[m*LDP + p]
  float* dts = dtx + MAX_L * LDP;  // dt
  float* css = dts + MAX_L;        // cs
  float* cole = css + MAX_L;       // sum_l E[l][m]
  float* rowp = cole + MAX_L;      // rowp[w*MAX_L + l]: sum_m E[l][m], by warp
  const int L = a.L, H = a.H, P = a.P, nc = a.T / L, tid = threadIdx.x;
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tx = tid & 15, ty = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const int P4 = (P + 3) & ~3, ng = (H + HEAD_GROUP - 1) / HEAD_GROUP;
  const long long hp = (long long)H * P;
  const long long row0 = (long long)b * a.T + (long long)c * L;
  const size_t bc = (size_t)b * nc + c;
  const float* cbt = a.cbt + bc * L * L;
  float ws[8][8];  // W^T of the group's heads so far (j >= i)
  zero(ws);
  for (int h = g * HEAD_GROUP; h < min(H, (g + 1) * HEAD_GROUP); ++h) {
    const size_t bhc = ((size_t)b * H + h) * nc + c;
    __syncthreads();  // the last head's tiles and sums are read
    cp_tile(dys, LDP, a.dy + row0 * hp + (long long)h * P, hp, L, MAX_L, P,
            PW);
    cp_tile(dtx, LDP, a.x + row0 * hp + (long long)h * P, hp, L, MAX_L, P,
            PW);
    if (tid < MAX_L) {
      dts[tid] = tid < L ? a.dt[(row0 + tid) * H + h] : 0.f;
      css[tid] = tid < L ? a.cs[bhc * L + tid] : 0.f;
    }
    cp_wait();
    __syncthreads();
    scale_rows(dtx, LDP, dts, MAX_L, PW);
    __syncthreads();
    float acc[8][8];
    zero(acc);
    mm_nt<8, 8, true>(acc, dtx + ty * LDP, LDP, dys + tx * LDP, LDP, P4);
    float er[8], ec[8];  // E^T's sums along this thread's rows / columns
#pragma unroll
    for (int i = 0; i < 8; ++i) er[i] = ec[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = i; j < 8; ++j) {
        const int m = ty + 16 * i, l = tx + 16 * j;
        const bool live = l < L && m <= l;
        const float d = live ? expf(css[l] - css[m]) : 0.f;
        const float cb = live ? __ldg(cbt + m * L + l) : 0.f;
        const float w = acc[i][j] * d;
        const float e = w * cb;
        ws[i][j] += w;
        er[i] += e;
        ec[j] += e;
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = half_warp_sum(er[i]);
      if (tx == 0) cole[ty + 16 * i] = v;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = ec[j] + __shfl_xor_sync(FULL, ec[j], 16);
      if (lane < 16) rowp[warp * MAX_L + tx + 16 * j] = v;
    }
    __syncthreads();
    if (tid < L) {
      float v = rowp[tid];
      for (int w = 1; w < NWARP; ++w) v += rowp[w * MAX_L + tid];
      a.dcs[bhc * L + tid] = v - cole[tid];
    }
  }
  float* out = a.wg + (bc * ng + g) * L * L;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = i; j < 8; ++j) {
      const int m = ty + 16 * i, l = tx + 16 * j;
      if (l < L && m <= l) out[m * L + l] = ws[i][j];
    }
}

// ---- b4. dx, ddt and dA's part, per (b, h, chunk) -------------------------
// Three products of (L, P) tiles, a thread's rows ty + 16 i and columns
// p0..p0+3: w o (B G_c) (not in the last chunk without a final state's
// gradient), then + M^T dy (ddtx: dx, ddtx . x), then C S_in (not in chunk
// 0: C_l . (exp(cs_l) S_in dy_l) = exp(cs_l) dy_l . (C S_in)_l).  The
// per-row sums over p by half-warp shuffles; the chunk's sums, dlam's
// reverse cumsum and dA's part in fixed trees.
constexpr size_t BD_SMEM = sizeof(double) * NWARP +
                           sizeof(float) * (NWARP + MAX_L * LD + MAX_L * LDP +
                                            6 * MAX_L);

__global__ void __launch_bounds__(NT, 2) ssd_bwd_dx_kernel(
    const SsdBwdArgs a) {
  extern __shared__ float smem[];
  double* redd = reinterpret_cast<double*>(smem);  // the warps' sums
  float* red = reinterpret_cast<float*>(redd + NWARP);
  float* t1 = red + NWARP;         // B, then M^T, then C: t1[r*LD + k]
  float* t2 = t1 + MAX_L * LD;     // G_c, then dy, then S_in: t2[k*LDP + p]
  float* dts = t2 + MAX_L * LDP;   // dt
  float* css = dts + MAX_L;        // cs
  float* ws = css + MAX_L;         // exp(cs_L - cs)
  float* uu = ws + MAX_L;          // u
  float* xd = uu + MAX_L;          // ddtx . x
  float* ct = xd + MAX_L;          // C_l . (exp(cs_l) S_in dy_l)
  const BItem it = bitem(a, blockIdx.x);
  const int N = a.N, L = a.L, H = a.H, P = a.P, tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4, p0 = 4 * tx;
  const int lane = tid & 31, warp = tid >> 5;
  const int N4 = (N + 3) & ~3, L4 = (L + 3) & ~3;
  const long long hp = (long long)H * P;
  const size_t np = (size_t)N * P;
  const long long o0 = it.row0 * hp + (long long)it.h * P;
  const float* xh = a.x + o0;  // x of row m: xh + m * hp
  const float* dyh = a.dy + o0;
  float* dxh = a.dx + o0;
  const bool vec = P % 4 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.dy) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.dx) & 15) == 0;
  const bool has_g = it.c + 1 < it.nc || a.dfinal != nullptr;
  const bool has_s = it.c > 0;
  if (has_g) {
    cp_tile(t1, LD, a.Bm + it.row0 * N, N, L, MAX_L, N, N4);
    cp_tile(t2, LDP, a.gs + it.bhc * np, P, N, N4, P, PW);
  }
  if (tid < MAX_L) {
    dts[tid] = tid < L ? a.dt[(it.row0 + tid) * H + it.h] : 0.f;
    css[tid] = tid < L ? a.cs[it.bhc * L + tid] : 0.f;
    uu[tid] = xd[tid] = ct[tid] = 0.f;
  }
  __syncthreads();
  const float cl = css[L - 1];
  if (tid < MAX_L) ws[tid] = tid < L ? expf(cl - css[tid]) : 0.f;
  cp_wait();
  __syncthreads();

  // w_m (B G_c)_m, and u_m = that . dtx_m
  float acc[8][4];
  zero(acc);
  if (has_g) {
    mm_tn<8, false>(acc, t1 + ty * LD, LD, t2 + p0, LDP, N4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty + 16 * i;
      float us = 0.f;
      if (m < L) {
        float xv[4];
        get4(xv, xh + m * hp, p0, P, vec);
        const float w = ws[m];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float v = acc[i][t] * w;
          us += v * (dts[m] * xv[t]);
          acc[i][t] = v;
        }
      }
      us = half_warp_sum(us);
      if (tx == 0) uu[m] = us;
    }
  }
  __syncthreads();  // B and G_c are read

  // ddtx = that + M^T dy, M^T[m][l] = (C B^T)^T[m][l] exp(cs_l - cs_m) for
  // m <= l < L (the masked exponential: no inf reaches a product)
  cp_tile(t2, LDP, dyh, hp, L, L4, P, PW);
  const float* cbt = a.cbt + it.bc * L * L;
  for (int e = tid; e < MAX_L * L4; e += NT) {
    const int m = e / L4, l = e - m * L4;
    t1[m * LD + l] =
        (m <= l && l < L) ? cbt[m * L + l] * expf(css[l] - css[m]) : 0.f;
  }
  cp_wait();
  __syncthreads();
  mm_tn<8, true>(acc, t1 + ty * LD, LD, t2 + p0, LDP, L4);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty + 16 * i;
    float xs = 0.f;
    if (m < L) {
      float xv[4], d[4];
      get4(xv, xh + m * hp, p0, P, vec);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        xs += acc[i][t] * xv[t];
        d[t] = dts[m] * acc[i][t];
      }
      put_row(dxh + m * hp, p0, P, vec, d);
    }
    xs = half_warp_sum(xs);
    if (tx == 0) xd[m] = xs;
  }
  __syncthreads();  // M^T and dy are read

  // exp(cs_l) dy_l . (C S_in)_l; <G_c, S_in>
  float gsum = 0.f;
  if (has_s) {
    cp_tile(t1, LD, a.Cm + it.row0 * N, N, L, MAX_L, N, N4);
    cp_tile(t2, LDP, a.st + it.bhc * np, P, N, N4, P, PW);
    cp_wait();
    __syncthreads();
    zero(acc);
    mm_tn<8, false>(acc, t1 + ty * LD, LD, t2 + p0, LDP, N4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int l = ty + 16 * i;
      float s = 0.f;
      if (l < L) {
        float dv[4];
        get4(dv, dyh + l * hp, p0, P, vec);
#pragma unroll
        for (int t = 0; t < 4; ++t) s += acc[i][t] * dv[t];
      }
      s = half_warp_sum(s);
      if (tx == 0) ct[l] = s * expf(css[l]);
    }
    if (has_g) {
      const float* gc = a.gs + it.bhc * np;
      float s = 0.f;
      for (int e = tid; e < N * P; e += NT) {
        const int n = e / P;
        s += gc[e] * t2[n * LDP + e - n * P];
      }
      gsum = block_sum(s, red);
    }
  }
  __syncthreads();  // uu, xd and ct are in
  const float usum = block_sum(tid < L ? uu[tid] : 0.f, red);

  // dcs; dlam, its in-chunk reverse cumsum (in double: a warp's lanes by
  // shuffles, then the later warps' sums in order); dA's part
  double run = 0.0;
  if (warp < MAX_L / 32) {  // one l a thread
    float v = 0.f;
    if (tid < L) {
      v = a.dcs[it.bhc * L + tid] + ct[tid] - uu[tid];
      if (tid == L - 1) v += expf(cl) * gsum + usum;
    }
    run = (double)v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_down_sync(FULL, run, o);
      if (lane + o < 32) run += up;
    }
    if (lane == 0) redd[warp] = run;
  }
  __syncthreads();
  double da = 0.0;
  if (warp < MAX_L / 32) {
    for (int w = MAX_L / 32 - 1; w > warp; --w) run += redd[w];
    if (tid < L) {
      a.ddt[(it.row0 + tid) * H + it.h] = (float)run * a.A[it.h] + xd[tid];
      da = run * (double)dts[tid];
    }
  }
  da = block_sum(da, redd);
  if (tid == 0) a.dAp[it.bhc] = (float)da;
}

// ---- b5. dB and dC once per (b, chunk, DBC_COLS columns); dA -------------
// A block's rows are all L of the chunk (a thread's ty + 16 i), its
// columns n0 + tx + 16 j.  dC = W B + sum_h exp(cs_h) o (dy_h S_in,h^T)
// and dB = W^T C + sum_h (w_h o dt_h) o (x_h G_c,h^T): W summed over the
// groups in order, then the heads in order, K = P each, two heads' tiles
// in flight (cp.async).  No dC term in chunk 0 (S_in is 0), no dB term in
// the last chunk without a final state's gradient (G is 0).
constexpr size_t BBC_SMEM =
    sizeof(float) * (2 * MAX_L * LDP + 2 * DBC_COLS * LDP + 2 * MAX_L);

__global__ void __launch_bounds__(NT, 2) ssd_bwd_dbc_kernel(
    const SsdBwdArgs a) {
  static_assert(MAX_L * LD <= 2 * MAX_L * LDP, "W^T fits the row tiles");
  static_assert(MAX_L * (DBC_COLS + 1) <= 2 * DBC_COLS * LDP,
                "B or C fits the column tiles");
  extern __shared__ float smem[];
  float* at = smem;  // W^T[m*LD + l]; then dy or x of a head, two buffers
  float* bt = at + 2 * MAX_L * LDP;  // B or C[k*(DBC_COLS+1) + n]; then
                                     // S_in or G_c rows n0.., two buffers
  float* fac = bt + 2 * DBC_COLS * LDP;  // the rows' factors, two buffers
  const int L = a.L, N = a.N, H = a.H, P = a.P, nc = a.T / L;
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int nq = (N + DBC_COLS - 1) / DBC_COLS, role = blockIdx.y / nq;
  const int n0 = (blockIdx.y - role * nq) * DBC_COLS;
  const int nw = min(DBC_COLS, N - n0);
  const int tx = tid & 15, ty = tid >> 4;
  const int P4 = (P + 3) & ~3, ng = (H + HEAD_GROUP - 1) / HEAD_GROUP;
  const long long hp = (long long)H * P;
  const long long row0 = (long long)b * a.T + (long long)c * L;
  const size_t bc = (size_t)b * nc + c, np = (size_t)N * P;

  // W^T = sum over the groups, in order (0 where m > l)
  const float* wg = a.wg + bc * ng * L * L;
  for (int e = tid; e < MAX_L * MAX_L; e += NT) {
    const int m = e / MAX_L, l = e - m * MAX_L;
    float v = 0.f;
    if (m <= l && l < L) {
      v = wg[m * L + l];
      for (int gi = 1; gi < ng; ++gi) v += wg[(size_t)gi * L * L + m * L + l];
    }
    at[m * LD + l] = v;
  }
  const float* src = role ? a.Cm : a.Bm;
  for (int e = tid; e < MAX_L * DBC_COLS; e += NT) {
    const int k = e / DBC_COLS, n = e - k * DBC_COLS;
    bt[k * (DBC_COLS + 1) + n] =
        (k < L && n < nw) ? src[(row0 + k) * N + n0 + n] : 0.f;
  }
  __syncthreads();
  // dC: sum_m W[l][m] B[m][n] (W[l][m] = W^T[m][l]); dB: sum_l W^T[m][l]
  // C[l][n]
  float acc[8][2];
  zero(acc);
  for (int k = 0; k < L; ++k) {
    float av[8], bv[2];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = role ? at[(ty + 16 * i) * LD + k] : at[k * LD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[j] = bt[k * (DBC_COLS + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }

  if (role ? (c + 1 < nc || a.dfinal != nullptr) : c > 0) {
    const float* asrc = (role ? a.x : a.dy) + row0 * hp;
    const float* bsrc = (role ? a.gs : a.st) + (size_t)n0 * P;
    auto issue = [&](int h, int buf) {
      const size_t bhc = ((size_t)b * H + h) * nc + c;
      cp_tile(at + buf * MAX_L * LDP, LDP, asrc + (long long)h * P, hp, L,
              MAX_L, P, PW);
      cp_tile(bt + buf * DBC_COLS * LDP, LDP, bsrc + bhc * np, P, nw,
              DBC_COLS, P, PW);
      if (tid < MAX_L) {
        float f = 0.f;
        if (tid < L) {
          const float* cs = a.cs + bhc * L;
          f = role ? expf(cs[L - 1] - cs[tid]) * a.dt[(row0 + tid) * H + h]
                   : expf(cs[tid]);
        }
        fac[buf * MAX_L + tid] = f;
      }
    };
    __syncthreads();  // W^T and B or C are read
    issue(0, 0);
    for (int h = 0; h < H; ++h) {
      const int cur = h & 1;
      cp_wait();
      __syncthreads();  // head h is in; head h - 1's buffers are read
      if (h + 1 < H) issue(h + 1, cur ^ 1);
      float t[8][2];
      zero(t);
      mm_nt<8, 2, false>(t, at + cur * MAX_L * LDP + ty * LDP, LDP,
                         bt + cur * DBC_COLS * LDP + tx * LDP, LDP, P4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float f = fac[cur * MAX_L + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = __fmaf_rn(f, t[i][j], acc[i][j]);
      }
    }
  }
  float* out = role ? a.dB : a.dC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= L) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = tx + 16 * j;
      if (n < nw) out[(row0 + r) * N + n0 + n] = acc[i][j];
    }
  }
  // dA over the batch and the chunks, in order, in double
  if (c == 0 && blockIdx.y == 0 && b == 0)
    for (int h = tid; h < H; h += NT) {
      double s = 0.0;
      for (int bb = 0; bb < a.Bb; ++bb)
        for (int cc = 0; cc < nc; ++cc)
          s += a.dAp[((size_t)bb * H + h) * nc + cc];
      a.dA[h] = (float)s;
    }
}

int launch_bwd(const SsdBwdArgs& a, cudaStream_t stream) {
  static int opted = -1;
  if (opted != 0) {
    opted = opt_in(ssd_bwd_q_kernel, BQ_SMEM);
    if (!opted) opted = opt_in(ssd_bwd_w_kernel, BW_SMEM);
    if (!opted) opted = opt_in(ssd_bwd_dx_kernel, BD_SMEM);
    if (!opted) opted = opt_in(ssd_bwd_dbc_kernel, BBC_SMEM);
    if (opted) return opted;
  }
  const int nc = a.T / a.L, ng = (a.H + HEAD_GROUP - 1) / HEAD_GROUP;
  const int nq = (a.N + DBC_COLS - 1) / DBC_COLS;
  const long long np = (long long)a.N * a.P;
  int err;
  if (nc > 1) {
    ssd_bwd_q_kernel<<<dim3(nc - 1, a.H, a.Bb), NT, BQ_SMEM, stream>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const int nb = (int)((np + PASS_NT * PASS_EL - 1) / (PASS_NT * PASS_EL));
  ssd_bwd_pass_kernel<<<dim3(nb, a.H, a.Bb), PASS_NT, 0, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_w_kernel<<<dim3(nc, ng, a.Bb), NT, BW_SMEM, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dx_kernel<<<dim3(nc, a.H, a.Bb), NT, BD_SMEM, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc_kernel<<<dim3(nc, 2 * nq, a.Bb), NT, BBC_SMEM, stream>>>(a);
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
