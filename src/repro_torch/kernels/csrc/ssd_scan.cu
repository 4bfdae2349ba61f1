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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

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
