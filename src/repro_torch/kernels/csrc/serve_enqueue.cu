// Ring service + two-pass enqueue of the fabric tick (lossy queues, no
// faults).
//
// Replaces: repro/kernels/fabric_kernels.py serve_enqueue_kernel (:184)
// -> fused_stage_kernel (Pallas, pallas_call at :176), running
// repro/sim/fabric.py serve_enqueue_core (:1165).
//
// Bound on the H100: bytes.  At perm1024 (Q = 3072 queue rows, M = 4096
// candidates, ring [Q+1, cap=682]) one tick must read each row's head
// slot (8 fields, ~100 KB) and the per-candidate lane inputs, and write
// the accepted candidates into the ring (at most M slots x 8 fields,
// ~100 KB): a few hundred KB, well under a microsecond at 3.35 TB/s.  The
// TPU kernel kept the whole ring in VMEM; here the ring stays in device
// memory and is touched only at the head slots and the placed slots, so
// the kernel moves O(Q + M) bytes, never the O(Q x cap) ring.  The chain
// is three short launches of its own (serve + candidate build,
// drop/accept, ring placement) around the two rank passes of the chunked
// ranker (rank.cu), with no host sync.  The reference counts all pairs
// for M <= 256 candidates instead; both give the same rank wherever the
// flag is set, and only flagged entries are read.
#include "common.cuh"

struct ServeParams {
  int t, Q, TS, T, S, N, M, cap, K;
  int data_drop, hard;
  float now, kmin, krecip, t_dither, mtu, ack_bytes;
};

struct Ring {  // [Q+1, cap] each
  int* flow;
  int* psn;
  float* ts;
  bool* probe;
  bool* ecn;
  int* ent;
  int* ready;
  int* spine;
};

struct Cands {  // [M] each (ready is t + 1 + K for all)
  int* qid;
  bool* valid;
  int* flow;
  int* psn;
  float* ts;
  bool* probe;
  bool* ecn;
  int* ent;
  int* spine;
};

struct ServeIn {
  const int* qhead;       // [Q+1]
  const int* qsize;       // [Q+1]
  const int* dst;         // [N]
  const int* dst_tor;     // [N]
  const int* total_pkts;  // [N]
  const float* tail_b;    // [N]
  const int* tx_psn;      // [N]
  const int* probe_psn;   // [N]
  const int* ent_d;       // [N]
  const int* ent_p;       // [N]
  const int* spine_d;     // [N]
  const int* spine_p;     // [N]
  const bool* sel;        // [N]
  const bool* probe_valid;  // [N]
  const int* inj_q;       // [N]
  const int* inj_qp;      // [N]
};

struct ServeOut {
  Ring pop;          // [Q] each
  bool* has;         // [Q]
  bool* ecn_out;     // [Q]
  float* pop_bytes;  // [Q]
  int* qhead;        // [Q+1]
  int* qsize;        // [Q+1] (qsize after serve; placement adds to it)
  int* qsize1;       // [Q+1] scratch: qsize after serve
};

namespace {

__device__ __forceinline__ float wire_bytes(int flow, int psn, bool probe,
                                            const ServeIn& in,
                                            const ServeParams& p) {
  int f = clampi(flow, 0, p.N - 1);
  bool tail = psn >= in.total_pkts[f] - 1;
  return probe ? p.ack_bytes : (tail ? in.tail_b[f] : p.mtu);
}

__global__ void serve_kernel(ServeParams p, Ring ring, ServeIn in,
                             ServeOut out, Cands c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == p.Q) {  // trash row resets
    out.qhead[p.Q] = 0;
    out.qsize[p.Q] = 0;
    out.qsize1[p.Q] = 0;
  }
  if (i < p.Q) {
    int qs = in.qsize[i];
    int h = floor_mod(in.qhead[i], p.cap);
    size_t slot = (size_t)i * p.cap + h;
    int flow = ring.flow[slot], psn = ring.psn[slot];
    float ts = ring.ts[slot];
    bool probe = ring.probe[slot], ecn = ring.ecn[slot];
    int ent = ring.ent[slot], ready = ring.ready[slot];
    int spine = ring.spine[slot];
    bool has = (qs > 0) && (ready <= p.t);
    float residual = (float)(qs - 1 > 0 ? qs - 1 : 0);
    float frac = fminf(fmaxf((residual - p.kmin) * p.krecip, 0.0f), 1.0f);
    float arg = p.t_dither + (float)i * 78.233f;  // no contraction
    float dither = fabsf(glibc_sinf(arg));
    bool mark = has && !probe && (frac > dither * 0.999f);
    bool ecn_o = ecn || mark;
    out.pop.flow[i] = flow;
    out.pop.psn[i] = psn;
    out.pop.ts[i] = ts;
    out.pop.probe[i] = probe;
    out.pop.ecn[i] = ecn;
    out.pop.ent[i] = ent;
    out.pop.ready[i] = ready;
    out.pop.spine[i] = spine;
    out.has[i] = has;
    out.ecn_out[i] = ecn_o;
    out.pop_bytes[i] = wire_bytes(flow, psn, probe, in, p);
    out.qhead[i] = in.qhead[i] + (int)has;
    out.qsize[i] = qs - (int)has;
    out.qsize1[i] = qs - (int)has;
    if (i < 2 * p.TS) {  // fabric advance: tor_up -> spine_down -> host_down
      int f = clampi(flow, 0, p.N - 1);
      bool up = i < p.TS;
      int spine_row = up ? i % p.S : (i - p.TS) / p.T;
      c.qid[i] = up ? p.TS + spine_row * p.T + in.dst_tor[f]
                    : 2 * p.TS + in.dst[f];
      c.valid[i] = has;
      c.flow[i] = flow;
      c.psn[i] = psn;
      c.ts[i] = ts;
      c.probe[i] = probe;
      c.ecn[i] = ecn_o;
      c.ent[i] = ent;
      c.spine[i] = spine;
    }
  }
  if (i >= 2 * p.TS && i < p.M) {  // NIC injections: data lanes, then probes
    int l = i - 2 * p.TS;
    bool is_probe = l >= p.N;
    if (is_probe) l -= p.N;
    c.qid[i] = is_probe ? in.inj_qp[l] : in.inj_q[l];
    c.valid[i] = is_probe ? in.probe_valid[l] : in.sel[l];
    c.flow[i] = l;
    c.psn[i] = is_probe ? in.probe_psn[l] : in.tx_psn[l];
    c.ts[i] = p.now;
    c.probe[i] = is_probe;
    c.ecn[i] = false;
    c.ent[i] = is_probe ? in.ent_p[l] : in.ent_d[l];
    c.spine[i] = is_probe ? in.spine_p[l] : in.spine_d[l];
  }
}

__global__ void accept_kernel(ServeParams p, Cands c,
                              const int* __restrict__ rank_v,
                              const int* __restrict__ qsize1,
                              bool* __restrict__ accept,
                              int* __restrict__ drops) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.M) return;
  bool valid = c.valid[i];
  int occ = qsize1[c.qid[i]] + rank_v[i];
  bool dropped = valid && ((!c.probe[i] && occ >= p.data_drop) ||
                           occ >= p.hard);
  accept[i] = valid && !dropped;
  if (dropped) atomicAdd(drops, 1);
}

__global__ void place_kernel(ServeParams p, Cands c,
                             const bool* __restrict__ accept,
                             const int* __restrict__ rank_a,
                             const int* __restrict__ qhead1,
                             const int* __restrict__ qsize1, Ring ring,
                             int* __restrict__ qsize) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.M || !accept[i]) return;
  int q = c.qid[i];
  int pos = floor_mod(qhead1[q] + qsize1[q] + rank_a[i], p.cap);
  size_t slot = (size_t)q * p.cap + pos;
  ring.flow[slot] = c.flow[i];
  ring.psn[slot] = c.psn[i];
  ring.ts[slot] = c.ts[i];
  ring.probe[slot] = c.probe[i];
  ring.ecn[slot] = c.ecn[i];
  ring.ent[slot] = c.ent[i];
  ring.ready[slot] = p.t + 1 + p.K;
  ring.spine[slot] = c.spine[i];
  atomicAdd(&qsize[q], 1);
}

}  // namespace

extern "C" int se_serve(const ServeParams* p, const Ring* ring,
                        const ServeIn* in, const ServeOut* out,
                        const Cands* c, cudaStream_t stream) {
  int n = (p->Q + 1 > p->M ? p->Q + 1 : p->M);
  serve_kernel<<<(n + 255) / 256, 256, 0, stream>>>(*p, *ring, *in, *out,
                                                     *c);
  return (int)cudaGetLastError();
}

extern "C" int se_accept(const ServeParams* p, const Cands* c,
                         const int* rank_v, const int* qsize1, bool* accept,
                         int* drops, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(drops, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  accept_kernel<<<(p->M + 255) / 256, 256, 0, stream>>>(*p, *c, rank_v,
                                                         qsize1, accept,
                                                         drops);
  return (int)cudaGetLastError();
}

extern "C" int se_place(const ServeParams* p, const Cands* c,
                        const bool* accept, const int* rank_a,
                        const int* qhead1, const int* qsize1,
                        const Ring* ring, int* qsize, cudaStream_t stream) {
  place_kernel<<<(p->M + 255) / 256, 256, 0, stream>>>(
      *p, *c, accept, rank_a, qhead1, qsize1, *ring, qsize);
  return (int)cudaGetLastError();
}
