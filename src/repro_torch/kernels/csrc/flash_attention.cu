// Flash attention (GQA, causal / sliding window, absolute query offset) for
// sm_90a.  Replaces src/repro/kernels/flash_attention.py::flash_attention,
// body _fa_kernel (pallas_call at :122).
//
// What it computes, as _fa_kernel does.  q (B,H,Tq,hd), k/v (B,K,Tk,hd);
// query row i of head h sits at absolute position q_pos = q_offset + i and
// reads kv head h / (H / K).  Key j is live iff j < Tk, j <= q_pos (causal)
// and j > q_pos - window (window).  Score s = (q . k) * scale with scale =
// 1/sqrt(hd); online softmax with the running max m (from -1e30), sum l and
// accumulator in float32; out = acc / max(l, 1e-20) in q's type, so a row
// with no live key gives 0.  Inputs are read through strides (the last
// dimension contiguous) and the output is written through strides, so the
// model layout (B,T,H,hd) and the KV cache need no copy.
//
// Three routes; the wrapper (kernels/flash_attention.py::_route) picks one
// per call, and each refuses what it does not take (no fallback):
//
// tc (bf16 q and k/v, Tq > 4: every bf16 prefill).  Bound by operations
//   (T = 1000, GQA 4:1: ~400 flop per byte), so the products run on the
//   tensor cores.  One block per (b*h, 128-row q tile), the longest causal
//   tiles launched first: two consumer warpgroups of 64 q rows and a
//   producer warpgroup, which hands its registers to them (setmaxnreg).
//   The producer keeps a ring of two 64-key K/V stages full with TMA
//   (cp.async.bulk.tensor, 128B swizzle, mbarrier transaction counts);
//   rows past T and columns past hd arrive as zeros,
//   which is what _fa_kernel's row_ok zeroing gives.  TMA rather than
//   cp.async: one thread issues a whole tile, the swizzle the tensor cores
//   read comes for free, and the out-of-bounds fill replaces every guard.
//   Per kv tile a consumer warpgroup runs S = Q K^T with wgmma (A = Q and
//   B = K from shared memory, both K-major), the online softmax on S in
//   f32 registers (exp2 of log2e-prescaled scores), then O += P V with
//   wgmma (A = P from registers: S's accumulator fragment is P's A
//   fragment once packed to bf16, so P never goes through shared memory;
//   B = V, MN-major, through the transpose bit).  P is rounded to bf16
//   before P V, as on every tensor-core flash attention (the plain version
//   keeps it in f32; the difference stays inside the bf16 tolerance).  hd
//   is padded to 16/32/64/80/128 (the products' widths) and loaded as
//   64-column boxes: at hd 80 the products cost nothing extra (K steps of
//   16 and an n80 product), only shared memory and the TMA fill do.  kv
//   tiles that are wholly masked for a warpgroup are skipped; the element
//   mask runs only on tiles that cross the causal diagonal, the window's
//   trailing edge or Tk.  ptxas holds the kernel to 168 registers a thread
//   (the 384-thread bound); 64-key tiles fit, 128-key tiles spilled at hd
//   128 and serialised the products (ptxas -v, C7512).
//
// decode (Tq <= 4, any type pair).  Bound by bytes (~4 flop per byte of
//   cache): each K/V row must be read once.  One 256-thread block per (b,
//   kv head, up to 8 rows of its group): the G = H / K query heads x Tq
//   rows that read that kv head share one pass over the cache.  The warps
//   split the keys in chunks of 32; per chunk a lane takes one key for
//   Q K^T (16-byte loads of its row straight into registers, the queries
//   in shared memory as f32) while the chunk's V rows stream into shared
//   memory with cp.async; each warp keeps an online softmax (m, l, acc) of
//   its own, and the block merges them in shared memory at the end.  Where
//   there are fewer such groups than SMs (llama3's decode: 32), each
//   group's keys are split over up to 8 blocks, still in one launch
//   (decode is host-bound, and a second launch a layer would cost more
//   than it saves): the split blocks form a thread-block cluster, and the
//   first reads the others' merged (acc, m, l) out of their shared memory.
//   All arithmetic is f32 FMAs, expf as the plain version.
//   A ring (a sliding-window decode cache: position p in slot p % Tk) is
//   walked by position, not by slot: the live positions [k_lo, k_hi) run
//   from the last query's position P back over at most Tk positions, no
//   further than the window and not below 0 (a slot never written holds
//   no position), and a key's row is its slot, p - base, or p - base + Tk
//   below base = P - P % Tk: at most two runs of slots (k_lo % Tk up to
//   Tk - 1, then 0 up to P % Tk), and no dead slot is read.  Without a
//   ring base is 0 and the row is the position.
//
// fma (Tq > 4 with f32 or mixed types: the f32 models and checks).  The
//   first kernel of this port: one block per (b*h, 64-row q tile), f32 FMAs
//   on the CUDA cores out of shared memory, each tile of 64 keys widened to
//   f32 there (rows past Tk are zeros, as _fa_kernel zeroes its ragged
//   tail), then
//   S = Q K^T * scale  256 threads, a 4x4 patch each (rows ty+16i,
//                      cols tx+16j);
//   softmax            one warp per 8 rows, two scores per lane, shuffles;
//   acc = acc*corr + P V   each thread keeps rows ty+16i, columns tx+16j of
//                      acc in registers.
//   Rows past Tq are skipped.  It is bound by its shared-memory loads.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
  void* o;                               // (B,H,Tq,hd), q's type
  long long sq[3], sk[3], sv[3], so[3];  // element strides of dims 0, 1, 2
  int B, H, K, Tq, Tk, hd;
  int causal, window, q_offset;   // window <= 0: no window
  float scale;
  int splits;  // decode: the keys of a group split over this many blocks
  int ring;    // decode: k/v are a ring of Tk slots, position p in p % Tk
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
  TQ* o = static_cast<TQ*>(a.o) + b * a.so[0] + h * a.so[1] + q0 * a.so[2];

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
      if (i < nri && c < hd) put(o + r * a.so[2] + c, acc[i][j] / l);
    }
  }
}

template <typename TQ, typename TKV>
int launch_fma(const FaArgs& a, cudaStream_t stream) {
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


// ---------------------------------------------------------------------------
// Hopper primitives: shared-memory addresses, mbarriers, TMA, wgmma.
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity ``parity`` of ``bar`` has completed.  A
// wait of 2^34 cycles (~10 s) is a lost arrival: trap, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One box of a 4-d tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (start address, leading
// and stride byte offsets in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

// D (64 x N, f32) {+}= A (64 x 16) * B (N x 16)^T, A and B in shared
// memory, both K-major bf16 behind 128B-swizzle descriptors; scale_d = 0
// overwrites D.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 16, bf16 in registers) * B (16 x N), B in
// shared memory MN-major (the transpose bit) behind a 128B-swizzle
// descriptor.
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace

// ---------------------------------------------------------------------------
// tc: tensor-core prefill.
namespace {
namespace tc {

constexpr int BQ = 128;         // q rows per block: two warpgroups of 64
constexpr int BK = 64;          // keys per kv tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int NCONS = 256;       // consumer threads: two warpgroups
constexpr int NT = NCONS + 128;  // and a producer warpgroup
constexpr int ROWB = 128;       // bytes of a swizzled box row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  CUtensorMap qmap, kmap, vmap;  // 4-d (hd, T, heads, B), 64-column boxes
  void* o;
  long long so[3];
  int H, K, Tq, Tk, hd, causal, window, q_offset;
  float c;  // scale * log2(e)
};

template <int HDP>
__host__ __device__ constexpr int n_box() {
  return (HDP + 63) / 64;
}

template <int HDP>
constexpr size_t smem_bytes() {
  // the q tile, STAGES x (K tile, V tile), 1 + 2 STAGES mbarriers and the
  // slack that aligns the tiles to the swizzle's 1024 bytes
  return (size_t)n_box<HDP>() * ROWB * (BQ + 2 * STAGES * BK) +
         8 * (1 + 2 * STAGES) + 1024;
}

__device__ __forceinline__ bool live(const Params& p, int qp, int kp) {
  return kp < p.Tk && (!p.causal || kp <= qp) &&
         (p.window <= 0 || kp > qp - p.window);
}

template <int HDP>
__global__ void __launch_bounds__(NT, 1)
    tc_kernel(const __grid_constant__ Params p) {
  constexpr int NBOX = n_box<HDP>();
  constexpr int QB = NBOX * BQ * ROWB;  // bytes of the q tile
  constexpr int KB = NBOX * BK * ROWB;  // bytes of one K (or V) tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + QB;  // stage s: K at kv_s + 2 s KB, V after it
  const uint32_t q_bar = kv_s + STAGES * 2 * KB;
  const uint32_t full_bar = q_bar + 8, empty_bar = full_bar + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.K);
  // the last q tiles have the most live kv tiles under a causal mask: start
  // them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int first_q = q0 + p.q_offset;
  const int last_q = min(q0 + BQ, p.Tq) - 1 + p.q_offset;
  int k_lo = 0, k_hi = p.Tk;
  if (p.causal) k_hi = min(k_hi, last_q + 1);
  if (p.window > 0) k_lo = max(0, first_q - p.window + 1);
  k_lo -= k_lo % BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NCONS / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == NCONS) {
      mbar_expect_tx(q_bar, QB);
      for (int x = 0; x < NBOX; ++x)
        tma_load(q_s + x * BQ * ROWB, &p.qmap, q_bar, 64 * x, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES)  // the stage's previous tile released
          mbar_wait(empty_bar + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, 2 * KB);
        const uint32_t ks = kv_s + s * 2 * KB;
        const int k0 = k_lo + t * BK;
        for (int x = 0; x < NBOX; ++x) {
          tma_load(ks + x * BK * ROWB, &p.kmap, full_bar + 8 * s, 64 * x, k0,
                   kh, b);
          tma_load(ks + KB + x * BK * ROWB, &p.vmap, full_bar + 8 * s, 64 * x,
                   k0, kh, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumers: warpgroup wg holds q rows 64 wg .. 64 wg + 63 of the tile;
    // this thread rows ra and ra + 8 (the accumulator fragment's layout)
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int wq0 = q0 + 64 * wg, wq1 = min(wq0 + 63, p.Tq - 1);
    const int ra = wq0 + 16 * warp + (lane >> 2);
    const int qa = ra + p.q_offset, qb = qa + 8;
    const int cq = 2 * (lane & 3);  // this thread's first column of each 8
    const float c = p.c;
    float o[HDP / 2], sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
    const uint32_t qw = q_s + 64 * wg * ROWB;  // this warpgroup's 64 q rows

    mbar_wait(q_bar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int k0 = k_lo + t * BK;
      const uint32_t ks = kv_s + s * 2 * KB, vs = ks + KB;
      mbar_wait(full_bar + 8 * s, (t / STAGES) & 1);
      // warpgroup-uniform: no row of this warpgroup sees a key of the tile
      const bool skip =
          wq0 >= p.Tq || (p.causal && k0 > wq1 + p.q_offset) ||
          (p.window > 0 && k0 + BK - 1 <= wq0 + p.q_offset - p.window);
      if (!skip) {
        // S = Q K^T (64 x BK), K steps of 16 over the padded hd
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t off = (kk & 3) * 32;  // 16 columns: 32 bytes
          wgmma_ss<BK>(sacc,
                        sw128_desc(qw + (kk >> 2) * BQ * ROWB + off, 16, 1024),
                        sw128_desc(ks + (kk >> 2) * BK * ROWB + off, 16, 1024),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sacc);

        // the element mask, only where the tile crosses Tk, the causal
        // diagonal or the window's trailing edge
        if (k0 + BK > p.Tk || (p.causal && k0 + BK - 1 > wq0 + p.q_offset) ||
            (p.window > 0 && k0 <= wq1 + p.q_offset - p.window)) {
#pragma unroll
          for (int i = 0; i < BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = k0 + 8 * i + cq + e;
              if (!live(p, qa, j)) sacc[4 * i + e] = -INFINITY;
              if (!live(p, qb, j)) sacc[4 * i + 2 + e] = -INFINITY;
            }
        }
        // online softmax in the log2 domain: x = s c - m, p = 2^x
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          mx0 = fmaxf(mx0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
        }
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {  // the four threads of a row
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
        }
        const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
        const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sacc[4 * i + e] = exp2f(__fmaf_rn(sacc[4 * i + e], c, -mn0));
            sacc[4 * i + 2 + e] =
                exp2f(__fmaf_rn(sacc[4 * i + 2 + e], c, -mn1));
            rs0 += sacc[4 * i + e];
            rs1 += sacc[4 * i + 2 + e];
          }
        l0 = __fmaf_rn(l0, corr0, rs0);  // this thread's columns; summed last
        l1 = __fmaf_rn(l1, corr1, rs1);
#pragma unroll
        for (int i = 0; i < HDP / 8; ++i) {
          o[4 * i] *= corr0;
          o[4 * i + 1] *= corr0;
          o[4 * i + 2] *= corr1;
          o[4 * i + 3] *= corr1;
        }
        // P as the A fragments of BK / 16 K steps, bf16 pairs in registers
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] =
                pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);

        // O += P V, V MN-major: 8-key groups 1024 bytes apart, 64-column
        // boxes BK rows apart
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<HDP>(o, pa[kk],
                        sw128_desc(vs + kk * 16 * ROWB, BK * ROWB, 1024));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
      }
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    }

    // out = O / max(l, 1e-20), bf16 pairs through the output strides
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
    __nv_bfloat16* ob =
        static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] + h * p.so[1];
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int col = 8 * i + cq;
      if (col >= p.hd) continue;
      if (ra < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + ra * p.so[2] + col) =
            __floats2bfloat162_rn(o[4 * i] / d0, o[4 * i + 1] / d0);
      if (ra + 8 < p.Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (ra + 8) * p.so[2] + col) =
            __floats2bfloat162_rn(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry-point
// query (the library is not linked against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 (B, heads, T, hd) view with element strides s (the last dimension
// contiguous) as a 4-d tensor map of 64-column, ``rows``-row boxes.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base, int B,
            int heads, int T, int hd, const long long* s, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)T,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int run(const Params& p, int B, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<HDP>());
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid(B * p.H, (p.Tq + BQ - 1) / BQ);
  tc_kernel<HDP><<<grid, NT, smem_bytes<HDP>(), stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const FaArgs& a, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  Params p;
  memset(&p, 0, sizeof p);
  if (!encode(enc, &p.qmap, a.q, a.B, a.H, a.Tq, a.hd, a.sq, BQ) ||
      !encode(enc, &p.kmap, a.k, a.B, a.K, a.Tk, a.hd, a.sk, BK) ||
      !encode(enc, &p.vmap, a.v, a.B, a.K, a.Tk, a.hd, a.sv, BK))
    return (int)cudaErrorInvalidValue;
  p.o = a.o;
  for (int i = 0; i < 3; ++i) p.so[i] = a.so[i];
  p.H = a.H;
  p.K = a.K;
  p.Tq = a.Tq;
  p.Tk = a.Tk;
  p.hd = a.hd;
  p.causal = a.causal;
  p.window = a.window;
  p.q_offset = a.q_offset;
  p.c = a.scale * LOG2E;
  if (a.hd <= 16) return run<16>(p, a.B, stream);
  if (a.hd <= 32) return run<32>(p, a.B, stream);
  if (a.hd <= 64) return run<64>(p, a.B, stream);
  if (a.hd <= 80) return run<80>(p, a.B, stream);
  return run<128>(p, a.B, stream);
}

}  // namespace tc
}  // namespace

// ---------------------------------------------------------------------------
// decode: the query rows of a GQA group against one pass over the cache.
namespace {
namespace dec {

namespace cg = cooperative_groups;

constexpr int NW = 8;        // warps per block
constexpr int NT = 32 * NW;  // threads per block
constexpr int CH = 32;       // keys per chunk: one per lane
constexpr float NEG_INF = -1e30f;

// 16 bytes of a row as float32
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
// four consecutive elements of a shared-memory row as float32
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

// 16 bytes from global to shared memory, zero-filled past ``bytes``
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// The cache row of key position p: its ring slot (base = P - P % Tk), or
// p itself without a ring (base 0)
__device__ __forceinline__ int slot(int p, int base, int Tk) {
  const int j = p - base;
  return j < 0 ? j + Tk : j;
}

// A chunk's loads (key positions j0 .. j0 + 31, k_hi the end of the live
// range): its V rows stream into the warp's shared memory (rows past k_hi
// as zeros) and this lane's K row, in 16-byte pieces, into ``raw`` (its
// first 256 bytes: all of it in bf16 up to hd 128).
template <typename TKV>
__device__ __forceinline__ void issue(const FaArgs& a, const TKV* k,
                                      const TKV* v, TKV* vw, uint4 (&raw)[16],
                                      int j0, int k_hi, int base, int lane) {
  constexpr int VE = 16 / sizeof(TKV);
  const int nv = min(CH, k_hi - j0), nvec = a.hd / VE;
  for (int e = lane; e < CH * nvec; e += 32) {
    const int r = e / nvec, x = e - r * nvec;
    cp_async16(smem_u32(vw + r * a.hd + x * VE),
               v + (long long)slot(j0 + min(r, nv - 1), base, a.Tk) * a.sv[2] +
                   x * VE,
               r < nv ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (lane < nv) {
    const TKV* kr = k + (long long)slot(j0 + lane, base, a.Tk) * a.sk[2];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nvec) raw[i] = *reinterpret_cast<const uint4*>(kr + i * VE);
  }
}

template <typename TKV, int RC>
size_t smem_bytes(int hd) {
  // the rows' queries, each warp's P and V chunk (after the loop: each
  // warp's acc, m and l for the merge)
  return sizeof(float) * ((size_t)RC * hd + (size_t)NW * RC * CH) +
         sizeof(TKV) * (size_t)NW * CH * hd;
}

template <typename TQ, typename TKV, int RC>
__global__ void __launch_bounds__(NT) dec_kernel(const FaArgs a) {
  constexpr int VE = 16 / sizeof(TKV);  // elements of a 16-byte load
  static_assert(RC <= 16, "the merge reuses the V chunks: RC x 4 <= CH x 2");
  extern __shared__ __align__(16) float dsm[];
  const int hd = a.hd, G = a.H / a.K, R = G * a.Tq;
  float* q_s = dsm;                                        // RC x hd
  float* p_s = q_s + RC * hd;                              // NW x RC x CH
  TKV* v_s = reinterpret_cast<TKV*>(p_s + NW * RC * CH);  // NW x CH x hd

  const int bk = blockIdx.x, b = bk / a.K, kh = bk - b * a.K;
  // block row r is query t = (r0 + r) % Tq of head kh G + (r0 + r) / Tq
  const int r0 = blockIdx.y * RC, n_rows = min(RC, R - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const TQ* q = static_cast<const TQ*>(a.q) + b * a.sq[0];
  const TKV* k = static_cast<const TKV*>(a.k) + b * a.sk[0] + kh * a.sk[1];
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.sv[0] + kh * a.sv[1];

  // live key positions [k_lo, k_hi); a ring holds positions P - Tk + 1 ..
  // P of the last query's P, the older ones overwritten
  const int P = a.q_offset + a.Tq - 1;
  int k_lo = 0, k_hi = a.Tk, base = 0;
  if (a.ring) {
    k_hi = P + 1;
    k_lo = max(0, k_hi - a.Tk);
    base = P >= 0 ? P - P % a.Tk : 0;
  } else if (a.causal) {
    k_hi = min(k_hi, a.q_offset + a.Tq);
  }
  if (a.window > 0) k_lo = max(k_lo, a.q_offset - a.window + 1);
  const int n_ch = k_hi > k_lo ? (k_hi - k_lo + CH - 1) / CH : 0;
  // this block's share of the chunks: split blockIdx.z of gridDim.z
  const int per = (n_ch + gridDim.z - 1) / gridDim.z;
  const int c_lo = blockIdx.z * per, c_hi = min(n_ch, c_lo + per);

  TKV* vw = v_s + warp * CH * hd;
  uint4 raw[16];
  // the first chunk's loads fly while the queries are staged
  if (c_lo + warp < c_hi)
    issue(a, k, v, vw, raw, k_lo + (c_lo + warp) * CH, k_hi, base, lane);
  for (int e = tid; e < RC * hd; e += NT) {
    const int r = e / hd, d = e - r * hd, gr = r0 + r;
    float x = 0.f;
    if (r < n_rows) {
      const int g = gr / a.Tq, t = gr - g * a.Tq;
      x = widen(q[(kh * G + g) * a.sq[1] + t * a.sq[2] + d]);
    }
    q_s[e] = x;
  }
  __syncthreads();

  float m[RC], l[RC], acc[RC][4];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }
  for (int ch = c_lo + warp; ch < c_hi; ch += NW) {
    const int j0 = k_lo + ch * CH, nv = min(CH, k_hi - j0);
    // Q K^T for this lane's key against every row's query
    const int j = j0 + lane;
    float s[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) s[r] = 0.f;
    if (lane < nv) {
      const TKV* kr = k + (long long)slot(j, base, a.Tk) * a.sk[2];
      for (int d0 = 0; d0 < hd; d0 += 16 * VE) {
        if (d0 > 0)  // f32 past 64 columns: the next 256 bytes
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (d0 + i * VE < hd)
              raw[i] = *reinterpret_cast<const uint4*>(kr + d0 + i * VE);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (d0 + i * VE >= hd) break;
          float kf[VE];
          unpack(raw[i], kf);
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            const float* qr = q_s + r * hd + d0 + i * VE;
#pragma unroll
            for (int e = 0; e < VE; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
              s[r] = __fmaf_rn(q4.x, kf[e], s[r]);
              s[r] = __fmaf_rn(q4.y, kf[e + 1], s[r]);
              s[r] = __fmaf_rn(q4.z, kf[e + 2], s[r]);
              s[r] = __fmaf_rn(q4.w, kf[e + 3], s[r]);
            }
          }
        }
      }
    }

    // online softmax of each row over the chunk: m warp-uniform, l this
    // lane's share
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      // j in [k_lo, k_hi): inside the cache (or the ring's positions) and
      // the window's bound of the last row; each row's own bounds here
      const int qp = a.q_offset + (r0 + r) % a.Tq;
      const bool lv = lane < nv && r < n_rows && (!a.causal || j <= qp) &&
                      (a.window <= 0 || j > qp - a.window);
      const float x = lv ? s[r] * a.scale : NEG_INF;
      const float mn = fmaxf(m[r], warp_max(x));
      const float pr = lv ? expf(x - mn) : 0.f;
      const float corr = expf(m[r] - mn);
      m[r] = mn;
      l[r] = __fmaf_rn(l[r], corr, pr);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= corr;
      p_s[(warp * RC + r) * CH + lane] = pr;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();

    // P V: this lane's four columns, four keys at a time
    if (4 * lane < hd) {
      for (int jj = 0; jj < nv; jj += 4) {
        float4 pr[RC];
#pragma unroll
        for (int r = 0; r < RC; ++r)
          pr[r] = *reinterpret_cast<const float4*>(
              p_s + (warp * RC + r) * CH + jj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vv[4];
          load4(vw + (jj + u) * hd + 4 * lane, vv);
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            const float pu = u == 0   ? pr[r].x
                             : u == 1 ? pr[r].y
                             : u == 2 ? pr[r].z
                                      : pr[r].w;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][e] = __fmaf_rn(pu, vv[e], acc[r][e]);
          }
        }
      }
    }
    __syncwarp();  // P and the V chunk consumed before the next chunk
    if (ch + NW < c_hi)
      issue(a, k, v, vw, raw, k_lo + (ch + NW) * CH, k_hi, base, lane);
  }

  // merge the warps' (m, l, acc): m the largest, l and acc rescaled to it
  // and summed; out = acc / max(l, 1e-20)
#pragma unroll
  for (int r = 0; r < RC; ++r) l[r] = warp_sum(l[r]);
  __syncthreads();
  float* m_s = p_s;                                 // NW x RC
  float* l_s = p_s + NW * RC;                       // NW x RC
  float* acc_s = reinterpret_cast<float*>(v_s);     // NW x RC x hd
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      m_s[warp * RC + r] = m[r];
      l_s[warp * RC + r] = l[r];
    }
  if (4 * lane < hd)
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc_s[(warp * RC + r) * hd + 4 * lane + e] = acc[r][e];
  __syncthreads();
  TQ* o = static_cast<TQ*>(a.o) + b * a.so[0];
  // with a split, this block's merged rows wait in shared memory for the
  // cluster's first block: acc over q_s (done with), m and l after the
  // warps' m and l
  const int S = gridDim.z;
  float* part_m = p_s + 2 * NW * RC;
  float* part_l = part_m + RC;
  for (int e = tid; e < n_rows * hd; e += NT) {
    const int r = e / hd, d = e - r * hd, gr = r0 + r;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w * RC + r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(m_s[w * RC + r] - mx);
      lsum = __fmaf_rn(l_s[w * RC + r], f, lsum);
      asum = __fmaf_rn(acc_s[(w * RC + r) * hd + d], f, asum);
    }
    if (S == 1) {
      const int g = gr / a.Tq, t = gr - g * a.Tq;
      put(o + (kh * G + g) * a.so[1] + t * a.so[2] + d,
          asum / fmaxf(lsum, 1e-20f));
    } else {
      q_s[r * hd + d] = asum;
      if (d == 0) {
        part_m[r] = mx;
        part_l[r] = lsum;
      }
    }
  }
  if (S == 1) return;

  // the cluster's first block merges the S blocks' rows the same way,
  // reading the others' shared memory; the second barrier keeps that
  // memory alive until it has
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int e = tid; e < n_rows * hd; e += NT) {
      const int r = e / hd, d = e - r * hd, gr = r0 + r;
      float mx = NEG_INF;
      for (int x = 0; x < S; ++x)
        mx = fmaxf(mx, cluster.map_shared_rank(part_m, x)[r]);
      float lsum = 0.f, asum = 0.f;
      for (int x = 0; x < S; ++x) {
        const float f = expf(cluster.map_shared_rank(part_m, x)[r] - mx);
        lsum = __fmaf_rn(cluster.map_shared_rank(part_l, x)[r], f, lsum);
        asum = __fmaf_rn(cluster.map_shared_rank(q_s, x)[r * hd + d], f,
                         asum);
      }
      const int g = gr / a.Tq, t = gr - g * a.Tq;
      put(o + (kh * G + g) * a.so[1] + t * a.so[2] + d,
          asum / fmaxf(lsum, 1e-20f));
    }
  }
  cluster.sync();
}

template <typename TQ, typename TKV, int RC>
int run(const FaArgs& a, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        dec_kernel<TQ, TKV, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<TKV, RC>(MAX_HD));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  // the split blocks of a group form one cluster (at most 8 blocks)
  const int R = a.H / a.K * a.Tq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.K, (R + RC - 1) / RC, a.splits);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes<TKV, RC>(a.hd);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = a.splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, dec_kernel<TQ, TKV, RC>, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// rows a block holds: 1 (MHA decode), up to 4 (llama3's group of 4), 8;
// kernels/flash_attention.py::_decode_grid mirrors the choice
template <typename TQ, typename TKV>
int launch(const FaArgs& a, cudaStream_t stream) {
  const int R = a.H / a.K * a.Tq;
  if (R <= 1) return run<TQ, TKV, 1>(a, stream);
  if (R <= 4) return run<TQ, TKV, 4>(a, stream);
  return run<TQ, TKV, 8>(a, stream);
}

}  // namespace dec
}  // namespace

// route: 0 fma, 1 tc, 2 decode (kernels/flash_attention.py ROUTES);
// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// or type the route does not take).
extern "C" int flash_attention(const FaArgs* a, int route, int q_bf16,
                               int kv_bf16, cudaStream_t stream) {
  if (a->hd < 1 || a->hd > MAX_HD || a->Tq < 1 || a->Tk < 1 || a->K < 1 ||
      a->H % a->K != 0 || (a->ring && route != 2))
    return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if ((q_bf16 && kv_bf16) || (a->Tq + BQ - 1) / BQ > 65535)
      return (int)cudaErrorInvalidValue;
    if (q_bf16) return launch_fma<__nv_bfloat16, float>(*a, stream);
    if (kv_bf16) return launch_fma<float, __nv_bfloat16>(*a, stream);
    return launch_fma<float, float>(*a, stream);
  }
  if (a->hd % 8 != 0) return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (!q_bf16 || !kv_bf16 || (a->Tq + tc::BQ - 1) / tc::BQ > 65535)
      return (int)cudaErrorInvalidValue;
    return tc::launch(*a, stream);
  }
  if (route == 2) {
    if ((a->H / a->K * a->Tq + 7) / 8 > 65535 || a->splits < 1 ||
        a->splits > 8)
      return (int)cudaErrorInvalidValue;
    if (q_bf16 && kv_bf16)
      return dec::launch<__nv_bfloat16, __nv_bfloat16>(*a, stream);
    if (q_bf16) return dec::launch<__nv_bfloat16, float>(*a, stream);
    if (kv_bf16) return dec::launch<float, __nv_bfloat16>(*a, stream);
    return dec::launch<float, float>(*a, stream);
  }
  return (int)cudaErrorInvalidValue;
}
