// Ring service + two-pass enqueue of the fabric tick, with its fault
// branches, and the tick's PFC stage: one launch each.
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
// the kernel moves O(Q + M) bytes, never the O(Q x cap) ring.  Every
// step is O(1) work a thread, so the cost is latency: the launch,
// dependent loads and grid-wide barriers, never bandwidth.
//
// Design: one cooperative launch (every block resident), grid-stride
// loops, two grid-wide barriers:
//   1. serve each row and build each candidate (as the reference does);
//      zero the per-queue counts; a valid candidate is flagged in accept;
//   2. each valid candidate takes a place in its queue's bucket from an
//      integer atomic, in no particular order: the first kBucket of a
//      queue in its fixed slots, any more in one overflow list;
//   3. one thread a queue walks its bucket in candidate order: occupancy
//      qsize1 + rank_v, the drop decision, rank_a among the accepted (not
//      derived from rank_v: a probe accepted past a dropped data packet
//      breaks the prefix), the ring slot and the new qsize.  A bucket of
//      up to kSmall is sorted in the thread's registers; a larger one is
//      taken by the whole warp, which gathers it (its fixed slots, then
//      its entries of the overflow list), sorts it by index (each
//      element's rank among the bucket, 32 at a time through shuffles:
//      O(k^2 / 32), slow only for a bucket of hundreds) and walks it 32
//      candidates at a time, rank_a from a ballot.
// The result depends on nothing the atomics ordered.  The drop and fault
// counters are zeroed inside (block 0, before the first barrier) and
// summed once per block at the end; no memset is left.  The reference
// counts all pairs for M <= 256 candidates and ranks with its chunked
// ranker above; every path gives the same rank wherever the flag is set,
// and only flagged entries are read.
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
// order.
//
// A batch of B entries (sim/fabric.py BatchProgram) is one launch of each
// kernel: every input and output but the fault rows (one schedule for the
// batch) has a leading axis B, the grid-stride loops run over B x (Q + 1)
// rows, B x M candidates and B x (T + S) switches through the same
// barriers, and each item works on its entry's views of the pointers
// (view_of, pfc_view): an entry's buckets, staging area and counts are
// its own.  An entry that live[e] marks frozen serves no row, enqueues no
// candidate and keeps its PFC state, so its rows are left as they were.
//
// The PFC stage (se_pfc) is the reference tick's inline stage 6b
// (repro/sim/fabric.py:1741-1841), which has no Pallas kernel; bound:
// bytes, O(ports x (S + HPT) + Q) reads a tick.  One cooperative launch,
// one grid-wide barrier:
//   1. one warp a ToR applies its uplink and host-down rows' dequeues to
//      the ingress counters of its hosts and of its spine downlinks, one
//      warp a spine its downlink rows' to the ToR uplinks into it: each
//      lane loads up to kRows rows, and each row's term goes to the
//      counter's owning lane through shuffles, in row order, into that
//      lane's registers; each host's lane then adds its lanes' data
//      injections, then its probes, in lane order (under the active set
//      each flow's lane is found by a binary search of the slate held in
//      shared memory), their loads issued with the rows'; one thread a
//      queue adds the accepted bytes onto qbytes in candidate order (a
//      warp where a queue took two or more);
//   2. one warp a switch sums its occupancy once, in the reference's
//      chunked order (ROADMAP C16), and steps the pause gate of each of
//      its ports.
// Every counter adds its terms in the order of the reference's scatters:
// dequeues by row, accepted advances, data injections, probes (ROADMAP
// C14); sequential float adds, never float atomics or a tree.  A warp
// holds at most kRows x 32 counters (HPT + S and T at most 128).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

struct ServeParams {
  int t, Q, TS, T, S, N, L, M, cap, K;
  int data_drop, hard;
  int fseed;  // the corruption draw's seed (31 bits)
  int B;      // entries of a batch (1 on one program)
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
  const bool* live;        // [B] a batch's stepping entries, null: all
};

struct ServeOut {
  Ring pop;           // [Q] each
  bool* has;          // [Q]
  bool* ecn_out;      // [Q]
  float* pop_bytes;   // [Q]
  int* qhead;         // [Q+1]
  int* qsize;         // [Q+1]
  bool* surv;         // [Q] the popped packets that go on; null w/o faults
  int* cand_qid;      // [M]
  bool* accept;       // [M]
  float* cand_bytes;  // [M] wire bytes
  int* counts;        // [3 B] drops, blackholed, corrupted of each entry
};

struct ServeScratch {  // one int32 allocation
  int* cnt;    // [Q+3] valid candidates of each queue; [Q+1] the overflow
               // list's length, [Q+2] the staging area's
  int* fixed;  // [(Q+1) kBucket] each queue's first kBucket candidates
  int* over;   // [M] the rest, of any queue
  int* stage;  // [2M] a large bucket gathered, then in candidate order
};

namespace {

constexpr int kThreads = 256;
constexpr int kBucket = 16;  // fixed bucket slots of a queue (<= 32)
constexpr int kSmall = 8;    // a bucket one thread walks alone
constexpr int kRows = 4;     // rows and counters a lane of a PFC warp holds
constexpr int kFlowRows = 8; // flows a lane of a ToR warp loads at once

__device__ __forceinline__ void grid_sync() { cg::this_grid().sync(); }

// Loads of what other threads wrote before the last barrier: from L2.
__device__ __forceinline__ int ld_i(const int* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bool ld_b(const bool* p) {
  return __ldcg(reinterpret_cast<const unsigned char*>(p)) != 0;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

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

// Entry e's pointers of a batch, its block's counters and whether it steps.
struct View {
  Ring ring;
  ServeIn in;
  ServeOut out;
  ServeScratch sc;
  int* cnt;  // the block's drops, blackholed, corrupted of entry e
  bool on;
};

__device__ __forceinline__ Ring ring_at(const Ring& r, size_t o) {
  return Ring{r.flow + o, r.psn + o, r.ts + o,    r.probe + o,
              r.ecn + o,  r.ent + o, r.ready + o, r.spine + o};
}

__device__ __forceinline__ View view_of(int e, const ServeParams& p,
                                        const Ring& ring, const ServeIn& in,
                                        const ServeOut& out,
                                        const ServeScratch& sc, int* s_cnt) {
  const size_t rq = (size_t)e * (p.Q + 1), q = (size_t)e * p.Q;
  const size_t n = (size_t)e * p.N, l = (size_t)e * p.L, m = (size_t)e * p.M;
  View v;
  v.ring = ring_at(ring, rq * p.cap);
  v.in = in;
  v.in.qhead += rq;
  v.in.qsize += rq;
  v.in.dst += n;
  v.in.dst_tor += n;
  v.in.total_pkts += n;
  v.in.tail_b += n;
  v.in.tx_psn += l;
  v.in.probe_psn += l;
  v.in.ent_d += l;
  v.in.ent_p += l;
  v.in.spine_d += l;
  v.in.spine_p += l;
  v.in.sel += l;
  v.in.probe_valid += l;
  v.in.inj_q += l;
  v.in.inj_qp += l;
  if (in.paused_row != nullptr) v.in.paused_row += q;
  if (in.lane_flow != nullptr) v.in.lane_flow += l;
  v.out = out;
  v.out.pop = ring_at(out.pop, q);
  v.out.has += q;
  v.out.ecn_out += q;
  v.out.pop_bytes += q;
  v.out.qhead += rq;
  v.out.qsize += rq;
  if (out.surv != nullptr) v.out.surv += q;
  v.out.cand_qid += m;
  v.out.accept += m;
  v.out.cand_bytes += m;
  v.out.counts += 3 * e;
  v.sc.cnt = sc.cnt + (size_t)e * (p.Q + 3);
  v.sc.fixed = sc.fixed + rq * kBucket;
  v.sc.over = sc.over + m;
  v.sc.stage = sc.stage + 2 * m;
  v.cnt = s_cnt + 3 * e;
  v.on = in.live == nullptr || in.live[e];
  return v;
}

// Phase 1 for row i (i < Q) of an entry: pop the head, mark, apply the
// fault rows; the row's fabric advance is candidate i (i < 2 TS).  qsize
// holds qsize1 (after service) until the walk adds the accepted.
__device__ void serve_row(int i, const ServeParams& p, const View& v) {
  const Ring& ring = v.ring;
  const ServeIn& in = v.in;
  const ServeOut& out = v.out;
  int* s_cnt = v.cnt;
  int qs = in.qsize[i];
  int h = floor_mod(in.qhead[i], p.cap);
  size_t slot = (size_t)i * p.cap + h;
  int flow = ring.flow[slot], psn = ring.psn[slot];
  float ts = ring.ts[slot];
  bool probe = ring.probe[slot], ecn = ring.ecn[slot];
  int ent = ring.ent[slot], ready = ring.ready[slot];
  int spine = ring.spine[slot];
  bool has = v.on && (qs > 0) && (ready <= p.t) &&
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
  bool surv = has;
  if (in.row_down != nullptr && has && in.row_down[i]) {
    surv = false;
    atomicAdd(&s_cnt[1], 1);
  }
  if (in.row_cor_p != nullptr && surv && !probe &&
      fault_u01(p.fseed, i, p.t, psn) < in.row_cor_p[i]) {
    surv = false;
    atomicAdd(&s_cnt[2], 1);
  }
  if (out.surv != nullptr) out.surv[i] = surv;
  if (i < 2 * p.TS) {  // fabric advance: tor_up -> spine_down -> host_down
    int f = clampi(flow, 0, p.N - 1);
    bool up = i < p.TS;
    int spine_row = up ? i % p.S : (i - p.TS) / p.T;
    out.cand_qid[i] = up ? p.TS + spine_row * p.T + in.dst_tor[f]
                         : 2 * p.TS + in.dst[f];
    out.accept[i] = surv;
    out.cand_bytes[i] = bytes;
  }
}

// Phase 1 for NIC injection candidate i (2 TS <= i < M): data lanes, then
// probes.
__device__ void inject(int i, const ServeParams& p, const View& v) {
  const ServeIn& in = v.in;
  const ServeOut& out = v.out;
  int l = i - 2 * p.TS;
  bool is_probe = l >= p.L;
  if (is_probe) l -= p.L;
  int flow = in.lane_flow != nullptr ? in.lane_flow[l] : l;
  int psn = is_probe ? in.probe_psn[l] : in.tx_psn[l];
  out.cand_qid[i] = is_probe ? in.inj_qp[l] : in.inj_q[l];
  out.accept[i] = v.on && (is_probe ? in.probe_valid[l] : in.sel[l]);
  out.cand_bytes[i] = wire_bytes(flow, psn, is_probe, in, p);
}

// A candidate's ring fields (ready is t + 1 + K for all).
struct Fields {
  int flow, psn, ent, spine;
  float ts;
  bool probe, ecn;
};

__device__ __forceinline__ Fields fields_of(int e, const ServeParams& p,
                                            const ServeIn& in,
                                            const ServeOut& out) {
  Fields c;
  if (e < 2 * p.TS) {  // a fabric advance: the popped packet
    c.flow = ld_i(out.pop.flow + e);
    c.psn = ld_i(out.pop.psn + e);
    c.ts = ld_f(out.pop.ts + e);
    c.probe = ld_b(out.pop.probe + e);
    c.ecn = ld_b(out.ecn_out + e);
    c.ent = ld_i(out.pop.ent + e);
    c.spine = ld_i(out.pop.spine + e);
  } else {  // a NIC injection of lane l
    int l = e - 2 * p.TS;
    c.probe = l >= p.L;
    if (c.probe) l -= p.L;
    c.flow = in.lane_flow != nullptr ? in.lane_flow[l] : l;
    c.psn = c.probe ? in.probe_psn[l] : in.tx_psn[l];
    c.ts = p.now;
    c.ecn = false;
    c.ent = c.probe ? in.ent_p[l] : in.ent_d[l];
    c.spine = c.probe ? in.spine_p[l] : in.spine_d[l];
  }
  return c;
}

__device__ __forceinline__ void place(const Fields& c, int q, int pos,
                                      const ServeParams& p,
                                      const Ring& ring) {
  size_t s = (size_t)q * p.cap + pos;
  ring.flow[s] = c.flow;
  ring.psn[s] = c.psn;
  ring.ts[s] = c.ts;
  ring.probe[s] = c.probe;
  ring.ecn[s] = c.ecn;
  ring.ent[s] = c.ent;
  ring.ready[s] = p.t + 1 + p.K;
  ring.spine[s] = c.spine;
}

// One thread walks row q's bucket of 1 <= k <= kSmall candidates (its
// fixed slots fx): sorted by index in registers (odd-even transposition),
// every candidate's fields loaded at once, then the decisions and the
// ring writes in candidate order.  Returns the accepted count.
__device__ int walk_small(int q, const int* fx, int k, int qs1, int qh1,
                          const ServeParams& p, const View& v) {
  const Ring& ring = v.ring;
  const ServeIn& in = v.in;
  const ServeOut& out = v.out;
  int e[kSmall];
#pragma unroll
  for (int u = 0; u < kSmall; ++u) e[u] = u < k ? ld_i(fx + u) : 0x7fffffff;
#pragma unroll
  for (int i = 0; i < kSmall; ++i) {
#pragma unroll
    for (int u = i & 1; u + 1 < kSmall; u += 2) {
      const int a = e[u], b = e[u + 1];
      e[u] = min(a, b);
      e[u + 1] = max(a, b);
    }
  }
  Fields c[kSmall];
#pragma unroll
  for (int u = 0; u < kSmall; ++u)
    if (u < k) c[u] = fields_of(e[u], p, in, out);
  int n_acc = 0, drops = 0;
#pragma unroll
  for (int u = 0; u < kSmall; ++u) {  // rank_v = u, rank_a = n_acc
    if (u < k) {
      const bool dropped =
          (!c[u].probe && qs1 + u >= p.data_drop) || qs1 + u >= p.hard;
      out.accept[e[u]] = !dropped;
      if (dropped) {
        ++drops;
      } else {
        place(c[u], q, floor_mod(qh1 + qs1 + n_acc, p.cap), p, ring);
        ++n_acc;
      }
    }
  }
  if (drops) atomicAdd(&v.cnt[0], drops);
  return n_acc;
}

// The whole warp walks row q's bucket of k > kSmall candidates: gathered
// into a staging area (its fixed slots, then its entries of the overflow
// list), sorted by index into the next k entries, then walked 32 at a
// time in that order.  Returns the accepted count (on every lane).
__device__ int walk_bucket(int q, int k, int qs1, int qh1,
                           const ServeParams& p, const View& v) {
  const Ring& ring = v.ring;
  const ServeIn& in = v.in;
  const ServeOut& out = v.out;
  const ServeScratch& sc = v.sc;
  const int lane = threadIdx.x & 31;
  int base = lane == 0 ? atomicAdd(&sc.cnt[p.Q + 2], 2 * k) : 0;
  base = __shfl_sync(FULL_MASK, base, 0);
  int* buf = sc.stage + base;
  int* srt = buf + k;
  const int nf = k < kBucket ? k : kBucket;
  if (lane < nf) buf[lane] = ld_i(sc.fixed + (size_t)q * kBucket + lane);
  if (k > kBucket) {
    const int n_over = ld_i(sc.cnt + p.Q + 1);
    int at = nf;
    for (int c = 0; c < n_over; c += 32) {
      int e = c + lane < n_over ? ld_i(sc.over + c + lane) : -1;
      bool mine = e >= 0 && ld_i(out.cand_qid + e) == q;
      unsigned bal = __ballot_sync(FULL_MASK, mine);
      if (mine) buf[at + __popc(bal & lanemask_lt())] = e;
      at += __popc(bal);
    }
  }
  __syncwarp();
  for (int c0 = 0; c0 < k; c0 += 32) {  // each element's rank = its place
    int j = c0 + lane;
    int x = j < k ? ld_i(buf + j) : 0x7fffffff;
    int pos = 0;
    for (int c1 = 0; c1 < k; c1 += 32) {
      int y = c1 == c0 ? x : (c1 + lane < k ? ld_i(buf + c1 + lane)
                                            : 0x7fffffff);
      int m = k - c1 < 32 ? k - c1 : 32;
      for (int s = 0; s < m; ++s) pos += __shfl_sync(FULL_MASK, y, s) < x;
    }
    if (j < k) srt[pos] = x;
  }
  __syncwarp();
  int n_acc = 0, drops = 0;
  for (int c0 = 0; c0 < k; c0 += 32) {
    int j = c0 + lane;
    bool ok = j < k;
    int e = ok ? ld_i(srt + j) : 0;
    Fields f;
    if (ok) f = fields_of(e, p, in, out);
    int occ = qs1 + j;
    bool dropped = ok && ((!f.probe && occ >= p.data_drop) || occ >= p.hard);
    bool acc = ok && !dropped;
    unsigned bal = __ballot_sync(FULL_MASK, acc);
    if (ok) {
      out.accept[e] = acc;
      if (acc) {
        int ra = n_acc + __popc(bal & lanemask_lt());
        place(f, q, floor_mod(qh1 + qs1 + ra, p.cap), p, ring);
      }
    }
    drops += dropped;
    n_acc += __popc(bal);
  }
  if (drops) atomicAdd(&v.cnt[0], drops);
  return n_acc;
}

__global__ void __launch_bounds__(kThreads)
    serve_enqueue_kernel(ServeParams p, Ring ring, ServeIn in, ServeOut out,
                         ServeScratch sc) {
  extern __shared__ int s_cnt[];  // [3 B] drops, blackholed, corrupted
  const int tid = threadIdx.x, lane = tid & 31;
  const int gtid = blockIdx.x * blockDim.x + tid;
  const int stride = gridDim.x * blockDim.x;
  const int nq = p.Q + 1;
  for (int i = tid; i < 3 * p.B; i += blockDim.x) s_cnt[i] = 0;
  for (int i = gtid; i < 3 * p.B; i += stride) out.counts[i] = 0;
  __syncthreads();

  // 1. serve, build the candidates, zero the counts
  const int n1 = nq + 2 > p.M ? nq + 2 : p.M;
  for (int g = gtid; g < p.B * n1; g += stride) {
    const int e = g / n1, i = g - e * n1;
    const View v = view_of(e, p, ring, in, out, sc, s_cnt);
    if (i < nq + 2) v.sc.cnt[i] = 0;
    if (i < p.Q) {
      serve_row(i, p, v);
    } else if (i == p.Q) {  // the trash row
      v.out.qhead[p.Q] = 0;
      v.out.qsize[p.Q] = 0;
    }
    if (i >= 2 * p.TS && i < p.M) inject(i, p, v);
  }
  grid_sync();

  // 2. each valid candidate into its queue's bucket: a fixed slot, or the
  // overflow list
  for (int g = gtid; g < p.B * p.M; g += stride) {
    const int e = g / p.M, i = g - e * p.M;
    const View v = view_of(e, p, ring, in, out, sc, s_cnt);
    if (!v.out.accept[i]) continue;
    const int q = v.out.cand_qid[i];
    const int s = atomicAdd(&v.sc.cnt[q], 1);
    if (s < kBucket)
      v.sc.fixed[(size_t)q * kBucket + s] = i;
    else
      v.sc.over[atomicAdd(&v.sc.cnt[p.Q + 1], 1)] = i;
  }
  grid_sync();

  // 3. the walk: one thread a queue, a warp for a bucket past kSmall
  const int n3 = p.B * nq;
  for (int g0 = gtid - lane; g0 < n3; g0 += stride) {
    const int g = g0 + lane;
    const bool act = g < n3;
    const int e = act ? g / nq : 0, q = act ? g - e * nq : 0;
    const View v = view_of(e, p, ring, in, out, sc, s_cnt);
    const int k = act ? ld_i(v.sc.cnt + q) : 0;
    const bool real = act && q < p.Q;
    const int qs1 = real ? v.out.qsize[q] : 0;  // this thread's own write
    const int qh1 = real ? v.out.qhead[q] : 0;
    int n_acc = 0;
    if (k >= 1 && k <= kSmall)
      n_acc = walk_small(q, v.sc.fixed + (size_t)q * kBucket, k, qs1, qh1, p,
                         v);
    unsigned big = __ballot_sync(FULL_MASK, k > kSmall);
    while (big) {
      const int src = __ffs(big) - 1;
      big &= big - 1;
      const int gs = __shfl_sync(FULL_MASK, g, src), es = gs / nq;
      const View vs = view_of(es, p, ring, in, out, sc, s_cnt);
      int r = walk_bucket(gs - es * nq, __shfl_sync(FULL_MASK, k, src),
                          __shfl_sync(FULL_MASK, qs1, src),
                          __shfl_sync(FULL_MASK, qh1, src), p, vs);
      if (lane == src) n_acc = r;
    }
    if (real) v.out.qsize[q] = qs1 + n_acc;
  }
  __syncthreads();
  for (int i = tid; i < 3 * p.B; i += blockDim.x)
    if (s_cnt[i] != 0) atomicAdd(&out.counts[i], s_cnt[i]);
}

// No work but n_sync grid-wide barriers: the launch floor of the
// cooperative launch (n_sync = 0: a launch of nothing).
__global__ void __launch_bounds__(kThreads) floor_kernel(int n_sync) {
  for (int i = 0; i < n_sync; ++i) grid_sync();
}

__global__ void draw_kernel(int seed, const int* __restrict__ row,
                            const int* __restrict__ t,
                            const int* __restrict__ psn,
                            float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = fault_u01(seed, row[i], t[i], psn[i]);
}

int n_sms() {
  static int cached[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return 132;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return cached[dev];
}

// Launch kern cooperatively on `want` blocks, or on as many as the card
// holds at once if fewer.
template <auto kern, class... Args>
int launch_cooperative(int want, size_t smem, cudaStream_t stream,
                       Args... args) {
  static size_t opted = 48 * 1024;  // one instantiation per kernel
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  static int per_sm = 0, per_sm_smem = -1;
  if ((int)smem != per_sm_smem) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    per_sm_smem = (int)smem;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int most = per_sm * n_sms();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(want < 1 ? 1 : (want < most ? want : most));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// A batch: B entries of every pointer but the fault rows (see above); at
// most kMaxBatch, whose counters a block holds in shared memory.
constexpr int kMaxBatch = 1024;

extern "C" int se_serve_enqueue(const ServeParams* p, const Ring* ring,
                                const ServeIn* in, const ServeOut* out,
                                const ServeScratch* sc, cudaStream_t stream) {
  if (p->B < 1 || p->B > kMaxBatch) return (int)cudaErrorInvalidValue;
  const long n = (long)p->B * (p->Q + 3 > p->M ? p->Q + 3 : p->M);
  return launch_cooperative<serve_enqueue_kernel>(
      (int)((n + kThreads - 1) / kThreads), sizeof(int) * 3 * p->B, stream,
      *p, *ring, *in, *out, *sc);
}

// The launch floor: an empty kernel of one warp (blocks 0), or the
// cooperative launch of `blocks` blocks that does nothing but n_sync
// grid-wide barriers.
extern "C" int se_floor(int blocks, int n_sync, cudaStream_t stream) {
  if (blocks == 0) {
    floor_kernel<<<1, 32, 0, stream>>>(0);
    return (int)cudaGetLastError();
  }
  return launch_cooperative<floor_kernel>(blocks, 0, stream, n_sync);
}

// The draw alone, at n keys (for holding it against its plain version).
extern "C" int se_draw(int seed, const int* row, const int* t, const int* psn,
                       float* out, int n, cudaStream_t stream) {
  if (n == 0) return 0;
  draw_kernel<<<(n + 255) / 256, 256, 0, stream>>>(seed, row, t, psn, out,
                                                   n);
  return (int)cudaGetLastError();
}

// ---- the PFC stage --------------------------------------------------------

struct PfcParams {
  int Q, TS, T, S, NH, HPT, N, L, cap, PD, line_row;
  int cS, cHPT, cT;  // the chunks the occupancy rows are summed in
  int B;             // entries of a batch (1 on one program)
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
  const bool* live;        // [B] a batch's stepping entries, null: all
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

// Entry e's pointers of a batch (each with a leading axis B) and whether
// it steps.
struct PfcView {
  PfcIn in;
  PfcState st, out;
  bool on;
};

__device__ __forceinline__ PfcState state_at(const PfcState& a,
                                             const PfcParams& p, int e) {
  const size_t ts = (size_t)e * p.TS, nh = (size_t)e * p.NH;
  const size_t line = (size_t)e * (p.PD > 0 ? p.PD : 1) * (p.NH + 2 * p.TS);
  return PfcState{a.qbytes + (size_t)e * (p.Q + 1),
                  a.ing_host + nh,
                  a.ing_sd + ts,
                  a.ing_up + ts,
                  a.paused_nic + nh,
                  a.paused_sd + ts,
                  a.paused_up + ts,
                  a.pfc_line + line,
                  a.pauses + e};
}

__device__ __forceinline__ PfcView pfc_view(int e, const PfcParams& p,
                                            const PfcIn& in,
                                            const PfcState& st,
                                            const PfcState& out) {
  const size_t q = (size_t)e * p.Q, rq = (size_t)e * (p.Q + 1);
  const size_t n = (size_t)e * p.N, m = (size_t)e * (2 * p.TS + 2 * p.L);
  const size_t rs = rq * p.cap;
  PfcView v;
  v.in = in;
  v.in.has += q;
  v.in.pop_flow += q;
  v.in.pop_bytes += q;
  v.in.pop_spine += q;
  v.in.accept += m;
  v.in.cand_bytes += m;
  v.in.ring_flow += rs;
  v.in.ring_psn += rs;
  v.in.ring_probe += rs;
  v.in.qhead += rq;
  v.in.qsize0 += rq;
  v.in.qsize += rq;
  v.in.src += n;
  v.in.src_tor += n;
  v.in.same_tor += n;
  v.in.total_pkts += n;
  v.in.tail_b += n;
  v.in.by_src += n;
  v.in.src_start += (size_t)e * (p.NH + 1);
  v.st = state_at(st, p, e);
  v.out = state_at(out, p, e);
  v.on = in.live == nullptr || in.live[e];
  return v;
}

constexpr int kSlateSmem = 8192;  // the largest slate held in shared memory

// The transport lane of flow f: f itself on the dense program, else its
// position in the ascending slate (n entries at slate), -1 when it holds
// no lane this tick.
__device__ __forceinline__ int lane_of(const int* slate, int n, int f) {
  if (slate == nullptr) return f;
  int lo = 0, hi = n;  // first lane with slate[lane] >= f
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (slate[mid] < f)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && slate[lo] == f ? lo : -1;
}

// The warp hands out U x 32 terms to their counters' owners, in
// order: lane l's u-th term is term u 32 + l, (tg[u], v[u]) with tg -1
// for none; counter x belongs to lane x % 32, whose acc[x / 32] adds the
// value.  Only the terms that exist pass through the shuffles.
template <int U>
__device__ __forceinline__ void hand_out(const int* tg, const float* v,
                                         float* acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    unsigned live = __ballot_sync(FULL_MASK, tg[u] >= 0);
    while (live) {
      const int s = __ffs(live) - 1;
      live &= live - 1;
      const int x = __shfl_sync(FULL_MASK, tg[u], s);
      const float y = __shfl_sync(FULL_MASK, v[u], s);
      if ((x & 31) == lane) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (x >> 5 == r) acc[r] = acc[r] + y;
      }
    }
  }
}

__device__ __forceinline__ float slot_bytes(const PfcIn& in,
                                            const PfcParams& p, size_t s) {
  int f = clampi(in.ring_flow[s], 0, p.N - 1);
  return in.ring_probe[s] ? p.ack_bytes
         : (in.ring_psn[s] >= in.total_pkts[f] - 1 ? in.tail_b[f] : p.mtu);
}

// ToR t: its uplink rows' and host-down rows' dequeues into the ingress
// counters of its hosts (counter j) and its spine downlinks (HPT + s);
// then its hosts' data injections, then their probes (its hosts' flows
// are by_src[src_start[t HPT] .. src_start[(t + 1) HPT]), each host's in
// lane order); then each downlink's accepted advance.  The loads go in
// three rounds: the rows, counters and flow range; the rows' flows'
// sources and the hosts' flows; those flows' sources, lanes, accept flags
// and bytes.
__device__ void tor_ingress(int t, const PfcParams& p, const PfcIn& in,
                            const PfcState& st, const PfcState& out,
                            const int* slate, bool on) {
  const int lane = threadIdx.x & 31;
  const int HPT = p.HPT, S = p.S, T = p.T, TS = p.TS, M0 = 2 * TS;
  const int h0 = t * HPT, n = S + HPT;
  const int f0 = in.src_start[h0], f1 = in.src_start[h0 + HPT];
  float acc[kRows], v[kRows];
  int tg[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int x = lane + 32 * r;
    acc[r] = x < HPT ? st.ing_host[h0 + x]
                     : (x < n ? st.ing_sd[(x - HPT) * T + t] : 0.0f);
    const int row = x < S ? t * S + x : M0 + h0 + (x - S);
    const bool has = on && x < n && in.has[row];
    const int f = clampi(x < n ? in.pop_flow[row] : 0, 0, p.N - 1);
    const int spn = x >= S && x < n ? in.pop_spine[row] : -1;
    v[r] = x < n ? -in.pop_bytes[row] : 0.0f;
    tg[r] = -1;
    if (!has) continue;
    if (x < S || in.same_tor[f]) {  // its source host, if in ToR t
      const int h = in.src[f] - h0;
      if (h >= 0 && h < HPT) tg[r] = h;
    } else if (spn >= 0 && spn < S) {  // the spine it came down from
      tg[r] = HPT + spn;
    }
  }
  hand_out<kRows>(tg, v, acc);
  // the injections, kFlowRows x 32 flows at a time: their data terms, then
  // their probes (all data terms first where the ToR has more flows)
  const int chunk = 32 * kFlowRows;
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = f0; c < f1; c += chunk) {
      int td[kFlowRows], tp[kFlowRows];
      float wd[kFlowRows], wp[kFlowRows];
#pragma unroll
      for (int u = 0; u < kFlowRows; ++u) {
        const int k = c + 32 * u + lane;
        const int f = k < f1 ? in.by_src[k] : -1;
        const int host = f >= 0 ? in.src[f] - h0 : -1;
        const int l = on && f >= 0 ? lane_of(slate, p.L, f) : -1;
        const int cd = M0 + pass * p.L + l;
        td[u] = l >= 0 && in.accept[cd] ? host : -1;
        wd[u] = l >= 0 ? in.cand_bytes[cd] : 0.0f;
        tp[u] = -1;
        wp[u] = 0.0f;
        if (pass == 0 && f1 - f0 <= chunk && l >= 0) {  // one chunk: both
          tp[u] = in.accept[M0 + p.L + l] ? host : -1;
          wp[u] = in.cand_bytes[M0 + p.L + l];
        }
      }
      hand_out<kFlowRows>(td, wd, acc);
      if (f1 - f0 <= chunk) hand_out<kFlowRows>(tp, wp, acc);
    }
    if (f1 - f0 <= chunk) break;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int x = lane + 32 * r;
    if (x < HPT) {
      out.ing_host[h0 + x] = acc[r];
    } else if (x < n) {
      const int i = (x - HPT) * T + t;
      out.ing_sd[i] = on && in.accept[TS + i]
                          ? acc[r] + in.cand_bytes[TS + i]
                          : acc[r];
    }
  }
}

// Spine s: its downlink rows' dequeues into the uplinks of their source
// ToRs (counter t), then each uplink's accepted advance.
__device__ void spine_ingress(int s, const PfcParams& p, const PfcIn& in,
                              const PfcState& st, const PfcState& out,
                              bool on) {
  const int lane = threadIdx.x & 31;
  const int S = p.S, T = p.T;
  float acc[kRows], v[kRows];
  int tg[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = lane + 32 * r;
    acc[r] = t < T ? st.ing_up[t * S + s] : 0.0f;
    const int row = p.TS + s * T + t;
    const bool has = on && t < T && in.has[row];
    const int f = clampi(t < T ? in.pop_flow[row] : 0, 0, p.N - 1);
    v[r] = t < T ? -in.pop_bytes[row] : 0.0f;
    const int tt = has ? in.src_tor[f] : -1;
    tg[r] = tt >= 0 && tt < T ? tt : -1;
  }
  hand_out<kRows>(tg, v, acc);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = lane + 32 * r;
    if (t < T)
      out.ing_up[t * S + s] = on && in.accept[t * S + s]
                                  ? acc[r] + in.cand_bytes[t * S + s]
                                  : acc[r];
  }
}

// Queues q0 .. q0 + 31, one a lane: the served bytes out, the accepted
// bytes in, in candidate order (the ring slots they were placed in); a
// queue that took two or more is summed by the whole warp.
__device__ void queue_bytes(int q0, const PfcParams& p, const PfcIn& in,
                            const PfcState& st, const PfcState& out,
                            bool on) {
  const int lane = threadIdx.x & 31;
  const int q = q0 + lane;
  int added = 0, base = 0;
  float v = 0.0f;
  if (q < p.Q) {
    bool has = on && in.has[q];
    v = st.qbytes[q];
    if (has) v = v + (-in.pop_bytes[q]);
    int qs1 = in.qsize0[q] - (int)has;
    added = on ? in.qsize[q] - qs1 : 0;
    base = in.qhead[q] + qs1;
    if (added == 1)
      v = v + slot_bytes(in, p, (size_t)q * p.cap + floor_mod(base, p.cap));
  }
  unsigned big = __ballot_sync(FULL_MASK, added >= 2);
  while (big) {
    const int src = __ffs(big) - 1;
    big &= big - 1;
    const int qq = q0 + src;
    const int n = __shfl_sync(FULL_MASK, added, src);
    const int b = __shfl_sync(FULL_MASK, base, src);
    float w = __shfl_sync(FULL_MASK, v, src);
    for (int c = 0; c < n; c += 32) {
      float x = c + lane < n
                    ? slot_bytes(in, p,
                                 (size_t)qq * p.cap + floor_mod(b + c + lane,
                                                                p.cap))
                    : 0.0f;
      int m = n - c < 32 ? n - c : 32;
      for (int s = 0; s < m; ++s) w = w + __shfl_sync(FULL_MASK, x, s);
    }
    if (lane == src) v = w;
  }
  if (q < p.Q)
    out.qbytes[q] = v;
  else if (q == p.Q)
    out.qbytes[p.Q] = 0.0f;
}

// x[0] + ... + x[n-1] on every lane of the warp, as the reference's
// program sums a row (ROADMAP C16): from zero, each chunk of c (a divisor
// of n) summed from zero one add after another, then the chunks' sums one
// after another; lane l holds x[32 u + l] in xs[u].
__device__ __forceinline__ float ordered_sum(const float* xs, int n, int c) {
  float total = 0.0f, part = 0.0f;
  int j = 0;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    int m = n - u * 32;
    if (m > 32) m = 32;
    for (int s = 0; s < m; ++s) {
      part = part + __shfl_sync(FULL_MASK, xs[u], s);
      if (++j == c) {
        total = total + part;
        part = 0.0f;
        j = 0;
      }
    }
  }
  return total;
}

__device__ __forceinline__ float xoff_of(const PfcParams& p, float occ) {
  return p.alpha * fmaxf(p.buf - occ, 0.0f) * p.inv;
}

// One hysteresis step of port `port` (NIC h, then spine_down [s][t], then
// tor_up [t][s]) against its switch's xoff; returns 1 on a new pause.  A
// frozen entry's port keeps its state (its delay line is copied whole).
__device__ __forceinline__ int gate(const PfcParams& p, float ing, float xoff,
                                    bool old, bool* paused, int port,
                                    const PfcState& out, bool on) {
  bool pause = ing > xoff, resume = ing < p.xon * xoff;
  bool now = on ? pause || (old && !resume) : old;
  *paused = now;
  if (p.PD > 0 && on)
    out.pfc_line[(size_t)p.line_row * (p.NH + 2 * p.TS) + port] = now;
  return now && !old;
}

// ToR t's occupancy (its uplink rows, then its host-down rows) and its
// ports' gates: its NICs (counter j) and its spine downlinks (HPT + s).
__device__ int tor_gates(int t, const PfcParams& p, const PfcState& st,
                         const PfcState& out, bool on) {
  const int lane = threadIdx.x & 31;
  const int HPT = p.HPT, S = p.S, T = p.T, TS = p.TS, n = HPT + S;
  float xa[kRows], xb[kRows], ing[kRows];
  bool old[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int x = lane + 32 * r;
    xa[r] = x < S ? ld_f(out.qbytes + t * S + x) : 0.0f;
    xb[r] = x < HPT ? ld_f(out.qbytes + 2 * TS + t * HPT + x) : 0.0f;
    ing[r] = 0.0f;
    old[r] = false;
    if (x < HPT) {
      ing[r] = ld_f(out.ing_host + t * HPT + x);
      old[r] = st.paused_nic[t * HPT + x];
    } else if (x < n) {
      ing[r] = ld_f(out.ing_sd + (x - HPT) * T + t);
      old[r] = st.paused_sd[(x - HPT) * T + t];
    }
  }
  const float a = ordered_sum(xa, S, p.cS), b = ordered_sum(xb, HPT, p.cHPT);
  const float xoff = xoff_of(p, a + b);
  int fresh = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int x = lane + 32 * r;
    if (x < HPT) {
      const int h = t * HPT + x;
      fresh += gate(p, ing[r], xoff, old[r], out.paused_nic + h, h, out, on);
    } else if (x < n) {
      const int k = (x - HPT) * T + t;
      fresh += gate(p, ing[r], xoff, old[r], out.paused_sd + k, p.NH + k,
                    out, on);
    }
  }
  return fresh;
}

// Spine s's occupancy (its downlink rows) and the gates of the ToR
// uplinks into it (counter t).
__device__ int spine_gates(int s, const PfcParams& p, const PfcState& st,
                           const PfcState& out, bool on) {
  const int lane = threadIdx.x & 31;
  const int S = p.S, T = p.T, TS = p.TS;
  float xs[kRows], ing[kRows];
  bool old[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = lane + 32 * r;
    xs[r] = t < T ? ld_f(out.qbytes + TS + s * T + t) : 0.0f;
    ing[r] = t < T ? ld_f(out.ing_up + t * S + s) : 0.0f;
    old[r] = t < T && st.paused_up[t * S + s];
  }
  const float xoff = xoff_of(p, ordered_sum(xs, T, p.cT));
  int fresh = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = lane + 32 * r;
    if (t < T) {
      const int k = t * S + s;
      fresh += gate(p, ing[r], xoff, old[r], out.paused_up + k,
                    p.NH + TS + k, out, on);
    }
  }
  return fresh;
}

__global__ void __launch_bounds__(kThreads)
    pfc_kernel(PfcParams p, PfcIn in, PfcState st, PfcState out) {
  extern __shared__ int s_slate[];  // [L] under the active set
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * blockDim.x + tid;
  const int stride = gridDim.x * blockDim.x;
  const int gwarp = gtid >> 5, nwarps = stride >> 5;
  const int T = p.T, S = p.S;
  const int ports = p.NH + 2 * p.TS;
  const int* slate = nullptr;
  if (in.lanes != nullptr) {  // one program (B = 1)
    if (p.L <= kSlateSmem) {
      for (int i = tid; i < p.L; i += blockDim.x) s_slate[i] = in.lanes[i];
      slate = s_slate;
    } else {
      slate = in.lanes;
    }
  }
  for (int e = gtid; e < p.B; e += stride) out.pauses[e] = st.pauses[e];
  __syncthreads();

  // 1. the ingress counters and queue bytes; the delay lines' other rows
  // (a frozen entry's every row)
  const int rows = p.PD > 0 ? p.PD : 1, line = rows * ports;
  for (int i = gtid; i < p.B * line; i += stride) {
    const int e = i / line;
    const bool on = in.live == nullptr || in.live[e];
    if (p.PD == 0 || (i - e * line) / ports != p.line_row || !on)
      out.pfc_line[i] = st.pfc_line[i];
  }
  const int nqw = (p.Q + 1 + 31) / 32, per = T + S + nqw;
  for (int w = gwarp; w < p.B * per; w += nwarps) {
    const int e = w / per, x = w - e * per;
    const PfcView v = pfc_view(e, p, in, st, out);
    if (x < T)
      tor_ingress(x, p, v.in, v.st, v.out, slate, v.on);
    else if (x < T + S)
      spine_ingress(x - T, p, v.in, v.st, v.out, v.on);
    else
      queue_bytes((x - T - S) * 32, p, v.in, v.st, v.out, v.on);
  }
  grid_sync();

  // 2. each switch's occupancy once, then its ports' gates
  for (int w = gwarp; w < p.B * (T + S); w += nwarps) {
    const int e = w / (T + S), x = w - e * (T + S);
    const PfcView v = pfc_view(e, p, in, st, out);
    const int fresh = x < T ? tor_gates(x, p, v.st, v.out, v.on)
                            : spine_gates(x - T, p, v.st, v.out, v.on);
    if (fresh) atomicAdd(v.out.pauses, fresh);
  }
}

}  // namespace

extern "C" int se_pfc(const PfcParams* p, const PfcIn* in, const PfcState* st,
                      const PfcState* out, cudaStream_t stream) {
  if (p->HPT + p->S > 32 * kRows || p->T > 32 * kRows || p->B < 1 ||
      (p->B > 1 && in->lanes != nullptr))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  if (in->lanes != nullptr && p->L <= kSlateSmem)
    smem = sizeof(int) * (size_t)p->L;
  const long warps = (long)p->B * (p->T + p->S + (p->Q + 1 + 31) / 32);
  return launch_cooperative<pfc_kernel>(
      (int)((warps + kThreads / 32 - 1) / (kThreads / 32)), smem, stream, *p,
      *in, *st, *out);
}
