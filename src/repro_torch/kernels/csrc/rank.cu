// Stable per-queue ranker: for each flagged candidate, its rank among the
// flagged candidates of the same queue in candidate-index order; -1 where
// unflagged.
//
// Replaces: repro/kernels/fabric_kernels.py rank_in_queue_kernel (Pallas,
// pallas_call at :130) over rank_in_queue_core (:67), and the
// reference's jnp path fabric._rank_in_queue (:730).
//
// Bound on the H100: bytes.  At perm1024 (M = 4096 candidates, Q = 3072
// queues) the inputs are 4096 x (4 + 1) bytes and the output 16 KB; the
// count table is nb x (Q+1) ints (16 x 3073, 197 KB), written, scanned
// and read once.  The work is tiny next to launch latency, so the design
// goal is three short launches with no host sync:
//   1. per 256-wide block, count flagged candidates per queue into the
//      [nb, Q+1] table (shared-nothing integer atomics: order-independent);
//   2. exclusive scan of each queue's column down the block axis, one
//      thread per queue (coalesced across threads);
//   3. base rank from the table plus the strictly-earlier same-queue
//      count inside the block, from shared memory.
// Deterministic and order-preserving: no atomics touch the ranks.
#include "common.cuh"

namespace {

constexpr int kChunk = 256;

__global__ void count_kernel(const int* __restrict__ qid,
                             const bool* __restrict__ flag,
                             int* __restrict__ tbl, int m, int qw) {
  int i = blockIdx.x * kChunk + threadIdx.x;
  if (i < m && flag[i]) atomicAdd(&tbl[blockIdx.x * qw + qid[i]], 1);
}

__global__ void scan_kernel(int* __restrict__ tbl, int nb, int qw) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= qw) return;
  int run = 0;
  for (int b = 0; b < nb; ++b) {
    int v = tbl[b * qw + q];
    tbl[b * qw + q] = run;
    run += v;
  }
}

__global__ void resolve_kernel(const int* __restrict__ qid,
                               const bool* __restrict__ flag,
                               const int* __restrict__ tbl,
                               int* __restrict__ out, int m, int qw) {
  __shared__ int sq[kChunk];
  __shared__ bool sf[kChunk];
  int i = blockIdx.x * kChunk + threadIdx.x;
  bool ok = i < m;
  sq[threadIdx.x] = ok ? qid[i] : -1;
  sf[threadIdx.x] = ok && flag[i];
  __syncthreads();
  if (!ok) return;
  if (!sf[threadIdx.x]) {
    out[i] = -1;
    return;
  }
  int q = sq[threadIdx.x];
  int cnt = 0;
  for (int j = 0; j < (int)threadIdx.x; ++j) cnt += (sf[j] && sq[j] == q);
  out[i] = tbl[blockIdx.x * qw + q] + cnt;
}

}  // namespace

extern "C" int rank_in_queue(const int* qid, const bool* flag, int* out,
                             int* tbl, int m, int n_queues,
                             cudaStream_t stream) {
  if (m <= 0) return 0;
  int nb = (m + kChunk - 1) / kChunk;
  int qw = n_queues + 1;
  cudaError_t err = cudaMemsetAsync(tbl, 0, sizeof(int) * (size_t)nb * qw,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  count_kernel<<<nb, kChunk, 0, stream>>>(qid, flag, tbl, m, qw);
  scan_kernel<<<(qw + 255) / 256, 256, 0, stream>>>(tbl, nb, qw);
  resolve_kernel<<<nb, kChunk, 0, stream>>>(qid, flag, tbl, out, m, qw);
  return (int)cudaGetLastError();
}
