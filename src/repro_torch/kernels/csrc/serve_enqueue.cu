// Ring service + two-pass enqueue of the fabric tick, with its fault
// branches, and the tick's PFC stage.
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
//
// Under PFC a paused row (paused_row, the effective pause mask; null on
// lossy queues) pops nothing, and every candidate's wire bytes go out in
// cand_bytes.
//
// Under the active set (repro/sim/fabric.py:1247-1272, fed at :1499) the
// NIC injections come from L transport lanes, not N flows: lane l sends
// for flow lane_flow[l] (the clipped slate), which the candidate carries
// and whose size and tail PSN set its wire bytes; M = 2 TS + 2 L.  A null
// lane_flow is the dense program (lane l is flow l, L = N).
//
// Under a fault schedule (repro/sim/fabric.py:1204-1236; each input null
// without one) a degraded row whose duty cycle is closed this tick
// (row_duty) pops nothing; a down row (row_down) pops but blackholes what
// it pops; a popped data packet that survives is corrupted, and dropped,
// when the counter-keyed draw fault_u01(seed, row, t, psn) falls below
// the row's probability (row_cor_p).  The draw is splitmix64 on 64-bit
// integers, the same stream the reference computes on two 32-bit limbs
// (repro/sim/faults.py:385-451).  Only the survivors become fabric
// advances (surv); the two counts are integer atomics, exact in any
// order.  Still one thread per row: the draw is ~40 integer operations,
// evaluated only for a surviving data packet on a corrupting row.  The PFC stage (se_pfc) is the reference tick's inline
// stage 6b (repro/sim/fabric.py:1741-1841), which has no Pallas kernel:
// one thread per ingress counter and per queue applies that counter's
// dequeues and accepted enqueues in the reference's scatter order
// (sequential float adds, never float atomics), then one thread per port
// sums its switch's queue bytes into the dynamic threshold and steps the
// pause gate.  Bound: bytes, O(ports x (S + HPT) + Q) reads a tick.
// Under the active set a host's injections are its flows' lanes: the
// host's thread walks its flows (by_src, ascending) and finds each one's
// lane by binary search in the ascending slate, so it still adds them in
// lane order, as the reference's scatter does.
#include "common.cuh"

struct ServeParams {
  int t, Q, TS, T, S, N, L, M, cap, K;
  int data_drop, hard;
  int fseed;  // the corruption draw's seed (31 bits)
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
  float* bytes;  // wire bytes
};

struct ServeIn {
  const int* qhead;       // [Q+1]
  const int* qsize;       // [Q+1]
  const int* dst;         // [N]
  const int* dst_tor;     // [N]
  const int* total_pkts;  // [N]
  const float* tail_b;    // [N]
  const int* tx_psn;      // [L]: per transport lane from here on
  const int* probe_psn;   // [L]
  const int* ent_d;       // [L]
  const int* ent_p;       // [L]
  const int* spine_d;     // [L]
  const int* spine_p;     // [L]
  const bool* sel;        // [L]
  const bool* probe_valid;  // [L]
  const int* inj_q;       // [L]
  const int* inj_qp;      // [L]
  const bool* paused_row;  // [Q], null on lossy queues
  const bool* row_down;    // [Q], null without link/host flaps
  const bool* row_duty;    // [Q], null without degraded links
  const float* row_cor_p;  // [Q], null without corrupting links
  const int* lane_flow;   // [L], null when lane l is flow l (L = N)
};

struct ServeOut {
  Ring pop;          // [Q] each
  bool* has;         // [Q]
  bool* ecn_out;     // [Q]
  float* pop_bytes;  // [Q]
  int* qhead;        // [Q+1]
  int* qsize;        // [Q+1] (qsize after serve; placement adds to it)
  int* qsize1;       // [Q+1] scratch: qsize after serve
  bool* surv;        // [Q] the popped packets that go on; null w/o faults
  int* fault_counts;  // [2] blackholed, corrupted; null without faults
};

namespace {

__device__ __forceinline__ float wire_bytes(int flow, int psn, bool probe,
                                            const ServeIn& in,
                                            const ServeParams& p) {
  int f = clampi(flow, 0, p.N - 1);
  bool tail = psn >= in.total_pkts[f] - 1;
  return probe ? p.ack_bytes : (tail ? in.tail_b[f] : p.mtu);
}

__device__ __forceinline__ unsigned long long splitmix64(
    unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  unsigned long long z = x;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

__device__ __forceinline__ unsigned long long key_of(int c) {
  // a counter cast to uint32, then zero-extended (the reference's
  // astype(uint32): a negative int wraps to 2^32 + c)
  return (unsigned long long)(unsigned int)c * 0x9E3779B97F4A7C15ull;
}

// f32 in [0, 1) from the top 24 bits of the keyed splitmix64 stream.
__device__ __forceinline__ float fault_u01(int seed, int row, int t,
                                          int psn) {
  unsigned long long s = splitmix64((unsigned long long)(unsigned int)seed);
  s = splitmix64(s ^ key_of(row));
  s = splitmix64(s ^ key_of(t));
  s = splitmix64(s ^ key_of(psn));
  return (float)(unsigned int)(s >> 40) * 0x1p-24f;
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
    bool has = (qs > 0) && (ready <= p.t) &&
               !(in.paused_row != nullptr && in.paused_row[i]) &&
               (in.row_duty == nullptr || in.row_duty[i]);
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
    float bytes = wire_bytes(flow, psn, probe, in, p);
    out.pop_bytes[i] = bytes;
    out.qhead[i] = in.qhead[i] + (int)has;
    out.qsize[i] = qs - (int)has;
    out.qsize1[i] = qs - (int)has;
    bool surv = has;
    if (in.row_down != nullptr && has && in.row_down[i]) {
      surv = false;
      atomicAdd(&out.fault_counts[0], 1);
    }
    if (in.row_cor_p != nullptr && surv && !probe &&
        fault_u01(p.fseed, i, p.t, psn) < in.row_cor_p[i]) {
      surv = false;
      atomicAdd(&out.fault_counts[1], 1);
    }
    if (out.surv != nullptr) out.surv[i] = surv;
    if (i < 2 * p.TS) {  // fabric advance: tor_up -> spine_down -> host_down
      int f = clampi(flow, 0, p.N - 1);
      bool up = i < p.TS;
      int spine_row = up ? i % p.S : (i - p.TS) / p.T;
      c.qid[i] = up ? p.TS + spine_row * p.T + in.dst_tor[f]
                    : 2 * p.TS + in.dst[f];
      c.valid[i] = surv;
      c.flow[i] = flow;
      c.psn[i] = psn;
      c.ts[i] = ts;
      c.probe[i] = probe;
      c.ecn[i] = ecn_o;
      c.ent[i] = ent;
      c.spine[i] = spine;
      c.bytes[i] = bytes;
    }
  }
  if (i >= 2 * p.TS && i < p.M) {  // NIC injections: data lanes, then probes
    int l = i - 2 * p.TS;
    bool is_probe = l >= p.L;
    if (is_probe) l -= p.L;
    int flow = in.lane_flow != nullptr ? in.lane_flow[l] : l;
    int psn = is_probe ? in.probe_psn[l] : in.tx_psn[l];
    c.qid[i] = is_probe ? in.inj_qp[l] : in.inj_q[l];
    c.valid[i] = is_probe ? in.probe_valid[l] : in.sel[l];
    c.flow[i] = flow;
    c.psn[i] = psn;
    c.ts[i] = p.now;
    c.probe[i] = is_probe;
    c.ecn[i] = false;
    c.ent[i] = is_probe ? in.ent_p[l] : in.ent_d[l];
    c.spine[i] = is_probe ? in.spine_p[l] : in.spine_d[l];
    c.bytes[i] = wire_bytes(flow, psn, is_probe, in, p);
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

__global__ void draw_kernel(int seed, const int* __restrict__ row,
                            const int* __restrict__ t,
                            const int* __restrict__ psn,
                            float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = fault_u01(seed, row[i], t[i], psn[i]);
}

}  // namespace

extern "C" int se_serve(const ServeParams* p, const Ring* ring,
                        const ServeIn* in, const ServeOut* out,
                        const Cands* c, cudaStream_t stream) {
  if (out->fault_counts != nullptr) {
    cudaError_t err =
        cudaMemsetAsync(out->fault_counts, 0, 2 * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  int n = (p->Q + 1 > p->M ? p->Q + 1 : p->M);
  serve_kernel<<<(n + 255) / 256, 256, 0, stream>>>(*p, *ring, *in, *out,
                                                     *c);
  return (int)cudaGetLastError();
}

// The draw alone, at n keys (for holding it against its plain version).
extern "C" int se_draw(int seed, const int* row, const int* t, const int* psn,
                       float* out, int n, cudaStream_t stream) {
  if (n == 0) return 0;
  draw_kernel<<<(n + 255) / 256, 256, 0, stream>>>(seed, row, t, psn, out,
                                                   n);
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

// ---- the PFC stage --------------------------------------------------------

struct PfcParams {
  int Q, TS, T, S, NH, HPT, N, L, cap, PD, line_row;
  float buf, alpha, inv, xon, mtu, ack_bytes;
};

struct PfcIn {
  const bool* has;         // [Q]
  const int* pop_flow;     // [Q]
  const float* pop_bytes;  // [Q]
  const int* pop_spine;    // [Q]
  const bool* accept;      // [M]
  const float* cand_bytes;  // [M]
  const int* ring_flow;    // [Q+1, cap], after placement
  const int* ring_psn;
  const bool* ring_probe;
  const int* qhead;        // [Q+1], after serve
  const int* qsize0;       // [Q+1], before serve
  const int* qsize;        // [Q+1], after placement
  const int* src;          // [N]
  const int* src_tor;      // [N]
  const bool* same_tor;    // [N]
  const int* total_pkts;   // [N]
  const float* tail_b;     // [N]
  const int* by_src;       // [N]: flows sorted by src (stable)
  const int* src_start;    // [NH + 1]
  const int* lanes;        // [L]: the active set's slate, ascending, padded
                           // with N; null when lane l is flow l (L = N)
};

struct PfcState {
  float* qbytes;     // [Q+1]
  float* ing_host;   // [NH]
  float* ing_sd;     // [S, T]
  float* ing_up;     // [T, S]
  bool* paused_nic;  // [NH]
  bool* paused_sd;   // [S, T]
  bool* paused_up;   // [T, S]
  bool* pfc_line;    // [max(PD, 1), NH + 2 TS]
  int* pauses;       // []
};

namespace {

__device__ __forceinline__ int pop_lane(const PfcIn& in, const PfcParams& p,
                                        int row) {
  return clampi(in.pop_flow[row], 0, p.N - 1);
}

// The transport lane of flow f: f itself on the dense program, else its
// position in the ascending slate, -1 when it holds no lane this tick.
__device__ __forceinline__ int lane_of(const PfcIn& in, const PfcParams& p,
                                       int f) {
  if (in.lanes == nullptr) return f;
  int lo = 0, hi = p.L;  // first lane with lanes[lane] >= f
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (in.lanes[mid] < f)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < p.L && in.lanes[lo] == f ? lo : -1;
}

// Ingress counters and queue bytes, each summed in the reference's order:
// dequeues (by row), then accepted advances, data and probe injections.
__global__ void pfc_ingress_kernel(PfcParams p, PfcIn in, PfcState st,
                                   PfcState out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int TS = p.TS, M0 = 2 * TS, ports = p.NH + 2 * TS;
  if (i == 0) *out.pauses = *st.pauses;  // the gate launch adds the new
  if (i < ports) {  // the delay line; the gate launch writes row line_row
    int rows = p.PD > 0 ? p.PD : 1;
    for (int r = 0; r < rows; ++r)
      out.pfc_line[(size_t)r * ports + i] = st.pfc_line[(size_t)r * ports + i];
  }
  if (i < p.NH) {  // host h's NIC, at ToR(h)
    int h = i, tor = h / p.HPT;
    float v = st.ing_host[h];
    for (int s = 0; s < p.S; ++s) {
      int row = tor * p.S + s;
      if (in.has[row] && in.src[pop_lane(in, p, row)] == h)
        v = v + (-in.pop_bytes[row]);
    }
    for (int j = 0; j < p.HPT; ++j) {
      int row = M0 + tor * p.HPT + j;
      int f = pop_lane(in, p, row);
      if (in.has[row] && in.same_tor[f] && in.src[f] == h)
        v = v + (-in.pop_bytes[row]);
    }
    int k0 = in.src_start[h], k1 = in.src_start[h + 1];
    for (int k = k0; k < k1; ++k) {
      int l = lane_of(in, p, in.by_src[k]);
      if (l >= 0 && in.accept[M0 + l]) v = v + in.cand_bytes[M0 + l];
    }
    for (int k = k0; k < k1; ++k) {
      int l = lane_of(in, p, in.by_src[k]);
      int c = M0 + p.L + l;
      if (l >= 0 && in.accept[c]) v = v + in.cand_bytes[c];
    }
    out.ing_host[h] = v;
    return;
  }
  i -= p.NH;
  if (i < TS) {  // ToR t's uplink into spine s: ing_up[t, s]
    int t = i / p.S, s = i % p.S;
    float v = st.ing_up[i];
    for (int t2 = 0; t2 < p.T; ++t2) {
      int row = TS + s * p.T + t2;
      if (in.has[row] && in.src_tor[pop_lane(in, p, row)] == t)
        v = v + (-in.pop_bytes[row]);
    }
    if (in.accept[i]) v = v + in.cand_bytes[i];
    out.ing_up[i] = v;
    return;
  }
  i -= TS;
  if (i < TS) {  // spine s's downlink into ToR t: ing_sd[s, t]
    int s = i / p.T, t = i % p.T;
    float v = st.ing_sd[i];
    for (int j = 0; j < p.HPT; ++j) {
      int row = M0 + t * p.HPT + j;
      int f = pop_lane(in, p, row);
      if (in.has[row] && !in.same_tor[f] && in.pop_spine[row] == s)
        v = v + (-in.pop_bytes[row]);
    }
    if (in.accept[TS + i]) v = v + in.cand_bytes[TS + i];
    out.ing_sd[i] = v;
    return;
  }
  i -= TS;
  if (i < p.Q) {  // queue row i: served bytes out, accepted bytes in
    bool has = in.has[i];
    float v = st.qbytes[i];
    if (has) v = v + (-in.pop_bytes[i]);
    int qs1 = in.qsize0[i] - (int)has;
    int added = in.qsize[i] - qs1;
    int base = in.qhead[i] + qs1;
    // the accepted, in candidate order, each added onto the occupancy (the
    // reference's qbytes + segment_sum, which XLA folds into one
    // scatter-add onto qbytes: with fractional tails the order shows)
    for (int r = 0; r < added; ++r) {
      size_t slot = (size_t)i * p.cap + floor_mod(base + r, p.cap);
      int f = clampi(in.ring_flow[slot], 0, p.N - 1);
      float w = in.ring_probe[slot] ? p.ack_bytes
                : (in.ring_psn[slot] >= in.total_pkts[f] - 1 ? in.tail_b[f]
                                                              : p.mtu);
      v = v + w;
    }
    out.qbytes[i] = v;
  } else if (i == p.Q) {
    out.qbytes[p.Q] = 0.0f;
  }
}

__device__ __forceinline__ float xoff_of(const PfcParams& p, float occ) {
  return p.alpha * fmaxf(p.buf - occ, 0.0f) * p.inv;
}

__device__ __forceinline__ float tor_occ(const PfcParams& p, const float* qb,
                                         int t) {
  float a = 0.0f, b = 0.0f;
  for (int s = 0; s < p.S; ++s) a = a + qb[t * p.S + s];
  for (int j = 0; j < p.HPT; ++j) b = b + qb[2 * p.TS + t * p.HPT + j];
  return a + b;
}

// One hysteresis step per port against its switch's dynamic threshold.
__global__ void pfc_gate_kernel(PfcParams p, PfcState st, PfcState out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int TS = p.TS;
  if (i >= p.NH + 2 * TS) return;
  const float* qb = out.qbytes;
  float ing, xoff;
  bool old;
  if (i < p.NH) {  // NIC h, paused by ToR(h)
    ing = out.ing_host[i];
    xoff = xoff_of(p, tor_occ(p, qb, i / p.HPT));
    old = st.paused_nic[i];
  } else if (i < p.NH + TS) {  // spine_down[s][t], paused by ToR t
    int k = i - p.NH;
    ing = out.ing_sd[k];
    xoff = xoff_of(p, tor_occ(p, qb, k % p.T));
    old = st.paused_sd[k];
  } else {  // tor_up[t][s], paused by spine s
    int k = i - p.NH - TS, s = k % p.S;
    float occ = 0.0f;
    for (int t = 0; t < p.T; ++t) occ = occ + qb[TS + s * p.T + t];
    ing = out.ing_up[k];
    xoff = xoff_of(p, occ);
    old = st.paused_up[k];
  }
  bool pause = ing > xoff, resume = ing < p.xon * xoff;
  bool now = pause || (old && !resume);
  if (i < p.NH)
    out.paused_nic[i] = now;
  else if (i < p.NH + TS)
    out.paused_sd[i - p.NH] = now;
  else
    out.paused_up[i - p.NH - TS] = now;
  if (p.PD > 0) out.pfc_line[(size_t)p.line_row * (p.NH + 2 * TS) + i] = now;
  if (now && !old) atomicAdd(out.pauses, 1);
}

}  // namespace

extern "C" int se_pfc(const PfcParams* p, const PfcIn* in, const PfcState* st,
                      const PfcState* out, cudaStream_t stream) {
  int ports = p->NH + 2 * p->TS;
  int n = ports + p->Q + 1;
  pfc_ingress_kernel<<<(n + 255) / 256, 256, 0, stream>>>(*p, *in, *st, *out);
  pfc_gate_kernel<<<(ports + 255) / 256, 256, 0, stream>>>(*p, *st, *out);
  return (int)cudaGetLastError();
}
