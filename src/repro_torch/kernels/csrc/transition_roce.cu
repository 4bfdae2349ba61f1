// RoCEv2 per-flow transitions of the fabric tick: apply the due return-pipe
// message (the CNP's DCQCN rate cut, then the cumulative ACK or the NACK's
// go-back-N rewind), run the DCQCN alpha and rate timers and the RTO rewind
// on timer ticks, offer the next packet through the window and pacing gate
// (the byte counter's stage step with it), and arbitrate each NIC round-
// robin, committing only the winner's send; under PFC a paused NIC commits
// nothing.
//
// Replaces: repro/kernels/fabric_kernels.py flow_transition_kernel (:191)
// -> fused_stage_kernel (Pallas, pallas_call at :176), running
// repro/sim/fabric.py dense_trans_core (:1079), and active_trans_core
// (:1120) under the active set, over the RoCEv2 protocol record
// (fabric.py:290-334, repro/sim/dcqcn_fab.py).
//
// Lanes, as in transition.cu: lane l steps flow act[l] of the slate (or
// flow l on the dense program, act null), in place in the [N] record, with
// the score (act[l] - t) % NR minimised over the flow's source NIC and the
// PFC gate read at that NIC; a padded lane (act[l] == N) is inert.
//
// A batch of B entries is one launch, as in transition.cu: a record of
// B FE flows, one block table over every entry, each flow's score by its
// index in its entry, and no due message or send in an entry live[e]
// marks frozen.
//
// Bound on the H100: bytes.  A flow's state is 19 scalars (76 B) and its
// due message 6 (14 B); the launch reads them, sendable and src, and writes
// the state and the two TxPacket rows (~110 B): ~200 B per flow, ~0.2 MB
// per tick at 1024 flows, well under a microsecond at 3.35 TB/s.
//
// Design: one launch of one-warp blocks, a thread a flow (no ledgers, so
// nothing to share within a warp), no scratch and no global atomics.  A
// block takes the flows of the source index's block (whole sources, at
// most 16 flows, or one source with more), in source order; each thread
// applies its flow's message and timers and proposes its send in
// registers, puts its score into its source's slot in shared memory with
// a shared atomicMin, and after one __syncthreads writes its flow's state
// once, with the send committed (psn_next, max_psn, the byte counter's
// DCQCN step, the pacing stamp) where its score is the minimum and the
// NIC is not paused.  A source of more than 32 flows is walked twice by
// the warp, once for the minimum and once to commit.  Under the active set
// the block stages the slate in shared memory and finds each flow's lane
// by binary search; a grid-strided pass writes the padded lanes' zero
// outputs.  Float32 follows the reference as XLA computes it on the CPU:
// built with -fmad=false, the CNP's alpha ewma is the one fmaf, and the
// scalar sums now + c arrive folded from the host: the ACK/NACK deadline
// and the pacing tolerance fused with the tick's product
// (numerics.now_plus), the RTO's re-arm a plain float add.
#include "common.cuh"

struct RoceParams {
  int t, timer_tick, N, L, NB, NR, F;
  int FE;  // flows an entry: N on one program, N / B of a batch's
  float now, pace_at, rto_at, rto_rearm, window, mtu, byte_counter, hai, rai,
      max_rate, min_rate, keep, g, alpha_timer, rate_timer, eps;
};

struct RoceFlowPtrs {
  int *snd_una, *psn_next, *total_pkts;
  float *rate, *target, *alpha;
  int *t_stage, *b_stage;
  float *bytes_ctr, *last_rate_ts, *last_alpha_ts, *next_send_ts,
      *rto_deadline;
  int *entropy, *retransmits;
  float* tail_bytes;
  int *max_psn, *rto_fires, *gbn_rewinds;
};

struct RoceMsgPtrs {
  const bool *valid, *ack, *nack, *cnp;
  const int* epsn;
  const float* bytes_recvd;
};

struct TxPtrs {
  bool* valid;
  int *psn, *entropy;
  bool *is_rtx, *is_probe;
};

struct RoceOut {  // [L] each
  TxPtrs tx, probe;
  bool *probe_valid, *sel, *can_tx;
  bool* done_lane;  // null on the dense program
};

constexpr int kThreads = 32;       // a block: one warp
constexpr int kSlateSmem = 8192;  // the largest slate held in shared memory

namespace {

struct Flow {
  int snd_una, psn_next, total, t_stage, b_stage, entropy, retx, max_psn,
      rto_fires, gbn;
  float rate, target, alpha, bytes_ctr, last_rate, last_alpha, next_send,
      rto_dl, tail;
};

// DCQCN phase step: hyper when both counters passed F, additive when
// either did, else fast recovery.
__device__ __forceinline__ void increase(const RoceParams& p, float rate,
                                         float target, int ts, int bs,
                                         float& rate_o, float& target_o) {
  int lo = ts < bs ? ts : bs, hi = ts < bs ? bs : ts;
  if (lo > p.F)
    target = fminf(target + p.hai, p.max_rate);
  else if (hi > p.F)
    target = fminf(target + p.rai, p.max_rate);
  target_o = target;
  rate_o = fminf((rate + target) * 0.5f, p.max_rate);
}

__device__ __forceinline__ void write_offer(TxPtrs tx, int l, bool valid,
                                            int psn, int entropy,
                                            bool is_rtx) {
  tx.valid[l] = valid;
  tx.psn[l] = psn;
  tx.entropy[l] = entropy;
  tx.is_rtx[l] = is_rtx;
  tx.is_probe[l] = false;
}

// One flow's step up to the arbitration: the committed state without a
// send, the offer, and the send's proposal.
struct Step {
  Flow s;
  bool can, can_tx, paused;
  int psn, score, bs;
  float n_rate, n_target, n_bytes_ctr, n_next_send;
};

__device__ __forceinline__ void step_flow(Step& st, const RoceParams& p,
                                          const RoceFlowPtrs& in,
                                          const RoceMsgPtrs& due,
                                          const bool* sendable,
                                          const bool* eff_nic,
                                          const bool* live, int f, int h) {
  Flow& s = st.s;
  s = Flow{in.snd_una[f],       in.psn_next[f],      in.total_pkts[f],
           in.t_stage[f],       in.b_stage[f],       in.entropy[f],
           in.retransmits[f],   in.max_psn[f],       in.rto_fires[f],
           in.gbn_rewinds[f],   in.rate[f],          in.target[f],
           in.alpha[f],         in.bytes_ctr[f],     in.last_rate_ts[f],
           in.last_alpha_ts[f], in.next_send_ts[f],  in.rto_deadline[f],
           in.tail_bytes[f]};
  st.paused = eff_nic != nullptr && eff_nic[h];
  // a frozen entry of a batch neither takes its due message nor sends
  const bool on = live == nullptr || live[f / p.FE];

  // ---- 1. the due message (roce_on_ack; no-op where invalid) ----
  if (due.valid[f] && on) {
    if (due.cnp[f]) {
      float old_rate = s.rate;
      s.rate = fmaxf(s.rate * (1.0f - s.alpha * 0.5f), p.min_rate);
      s.target = old_rate;
      s.alpha = __fmaf_rn(s.alpha, p.keep, p.g);
      s.t_stage = 0;
      s.b_stage = 0;
      s.bytes_ctr = 0.0f;
      s.last_rate = p.now;
      s.last_alpha = p.now;
    }
    int epsn = due.epsn[f];
    bool nack = due.nack[f];
    bool adv = (due.ack[f] || nack) && epsn > s.snd_una;
    if (adv) s.snd_una = epsn;
    if (nack) {
      int rewind_to = s.snd_una > epsn ? s.snd_una : epsn;
      int back = s.psn_next - epsn;
      s.retx += back > 0 ? back : 0;
      s.gbn += (int)(s.psn_next > rewind_to);
      s.psn_next = rewind_to;
    }
    if (adv || nack) s.rto_dl = p.rto_at;
  }

  // ---- 2. DCQCN timers and the RTO on timer ticks (released flows) ----
  // lanes: released
  bool send_ok = (sendable == nullptr || sendable[f]) && on;
  if (p.timer_tick && send_ok) {
    bool active = s.snd_una < s.total;
    if (active && p.now - s.last_alpha >= p.alpha_timer) {
      s.alpha = p.keep * s.alpha;
      s.last_alpha = p.now;
    }
    if (active && p.now - s.last_rate >= p.rate_timer) {
      s.t_stage += 1;
      increase(p, s.rate, s.target, s.t_stage, s.b_stage, s.rate, s.target);
      s.last_rate = p.now;
    }
    if (active && p.now >= s.rto_dl) {
      int back = s.psn_next - s.snd_una;
      s.retx += back > 0 ? back : 0;
      s.psn_next = s.snd_una;
      s.rto_dl = p.rto_rearm;
      s.rto_fires += 1;
    }
  }

  // ---- 3. next-packet offer (roce_next_packet) and the send's proposal ----
  bool window_open = s.psn_next < s.total &&
                     (float)(s.psn_next - s.snd_una) < p.window;
  st.can = s.snd_una < s.total && window_open && p.pace_at >= s.next_send;
  st.psn = s.psn_next;
  float size = st.psn >= s.total - 1 ? s.tail : p.mtu;
  float bctr = s.bytes_ctr + size;
  bool b_hit = bctr >= p.byte_counter;
  st.bs = s.b_stage + (int)b_hit;
  st.n_rate = s.rate;
  st.n_target = s.target;
  if (b_hit)
    increase(p, s.rate, s.target, s.t_stage, st.bs, st.n_rate, st.n_target);
  st.n_bytes_ctr = b_hit ? 0.0f : bctr;
  st.n_next_send = p.now + size / fmaxf(st.n_rate, p.eps);
  st.can_tx = st.can && send_ok;
  st.score = st.can_tx ? floor_mod(f % p.FE - p.t, p.NR) : p.NR;
}

// The flow's state, once: with the send committed where sel.
__device__ __forceinline__ void commit(const Step& st, bool sel,
                                       const RoceParams& p,
                                       const RoceFlowPtrs& out,
                                       const RoceOut& o, int f, int l) {
  const Flow& s = st.s;
  out.snd_una[f] = s.snd_una;
  out.psn_next[f] = sel ? s.psn_next + 1 : s.psn_next;
  out.total_pkts[f] = s.total;
  out.rate[f] = sel ? st.n_rate : s.rate;
  out.target[f] = sel ? st.n_target : s.target;
  out.alpha[f] = s.alpha;
  out.t_stage[f] = s.t_stage;
  out.b_stage[f] = sel ? st.bs : s.b_stage;
  out.bytes_ctr[f] = sel ? st.n_bytes_ctr : s.bytes_ctr;
  out.last_rate_ts[f] = s.last_rate;
  out.last_alpha_ts[f] = s.last_alpha;
  out.next_send_ts[f] = sel ? st.n_next_send : s.next_send;
  out.rto_deadline[f] = s.rto_dl;
  out.entropy[f] = s.entropy;
  out.retransmits[f] = s.retx;
  out.tail_bytes[f] = s.tail;
  out.max_psn[f] = sel && s.psn_next + 1 > s.max_psn ? s.psn_next + 1
                                                     : s.max_psn;
  out.rto_fires[f] = s.rto_fires;
  out.gbn_rewinds[f] = s.gbn;

  write_offer(o.tx, l, st.can, st.psn, s.entropy,
              st.can && st.psn < s.max_psn);
  // RoCEv2 sends no probes; the timer's empty slot carries the entropy
  write_offer(o.probe, l, false, 0, p.timer_tick ? s.entropy : 0, false);
  o.probe_valid[l] = false;
  o.can_tx[l] = st.can_tx;
  o.sel[l] = sel;
  if (o.done_lane != nullptr) o.done_lane[l] = s.snd_una >= s.total;
}

// position in the ascending slate (n entries), -1 when it holds no f; the
// flow itself on the dense program
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

__global__ void __launch_bounds__(kThreads)
    roce_kernel(RoceParams p, RoceFlowPtrs in, RoceMsgPtrs due,
                const bool* __restrict__ sendable,
                const bool* __restrict__ eff_nic,
                const bool* __restrict__ live,
                const int* __restrict__ act, const int* __restrict__ by_src,
                const int* __restrict__ src_sorted,
                const int* __restrict__ blocks, RoceFlowPtrs out, RoceOut o) {
  extern __shared__ int s_slate[];  // [L] under the active set
  __shared__ int s_min[kThreads];
  const int lane = threadIdx.x;

  // the slate's padded lanes, strided over the grid: inert
  if (act != nullptr)
    for (int l = blockIdx.x * kThreads + lane; l < p.L;
         l += gridDim.x * kThreads)
      if (act[l] >= p.N) {
        write_offer(o.tx, l, false, 0, 0, false);
        write_offer(o.probe, l, false, 0, 0, false);
        o.probe_valid[l] = false;
        o.can_tx[l] = false;
        o.sel[l] = false;
        o.done_lane[l] = false;
      }
  if ((int)blockIdx.x >= p.NB) return;
  const int p0 = blocks[blockIdx.x], n = blocks[blockIdx.x + 1] - p0;
  s_min[lane] = p.NR;
  const int* slate = nullptr;
  if (act != nullptr) {
    if (p.L <= kSlateSmem) {
      for (int i = lane; i < p.L; i += kThreads) s_slate[i] = act[i];
      slate = s_slate;
    } else {
      slate = act;
    }
  }
  __syncthreads();

  // a thread a flow: up to kThreads flows in one round, its source's slot
  // the source's first position in the block (sources come in order); a
  // source of more flows is walked twice, the first pass for its minimum
  // (slot 0), the second recomputing each flow to commit it
  const bool loop = n > kThreads;
  int f = 0, l = -1, h = -1, slot = 0;
  if (!loop) {
    if (lane < n) {
      f = by_src[p0 + lane];
      h = src_sorted[p0 + lane];
      l = lane_of(slate, p.L, f);
    }
    int h_prev = __shfl_up_sync(FULL_MASK, h, 1);
    uint32_t starts =
        __ballot_sync(FULL_MASK, lane < n && (lane == 0 || h != h_prev));
    slot = 31 - __clz(starts & (FULL_MASK >> (31 - lane)));
  }
  const int per_pass = loop ? (n + kThreads - 1) / kThreads : 1;
  const int rounds = loop ? 2 * per_pass : 1;
  for (int r = 0; r < rounds; ++r) {  // block-uniform
    const int pass = loop ? r / per_pass : 1;  // 0: the minimum only
    if (loop) {
      const int i = (r % per_pass) * kThreads + lane;
      f = i < n ? by_src[p0 + i] : 0;
      h = i < n ? src_sorted[p0 + i] : 0;
      l = i < n ? lane_of(slate, p.L, f) : -1;
    }
    Step st;
    if (l >= 0) {
      step_flow(st, p, in, due, sendable, eff_nic, live, f, h);
      if (pass == 0 || !loop) atomicMin(&s_min[slot], st.score);
    }
    if (!loop || r == per_pass - 1) __syncthreads();
    if (l >= 0 && pass == 1)
      commit(st, st.can_tx && st.score == s_min[slot] && !st.paused, p, out,
             o, f, l);
  }
}

}  // namespace

// sendable: [N] on the dense program (act null, L = N); null under the
// active set, whose lanes are released by construction (act: [L]).
// by_src [N], src_sorted [N] and blocks [NB + 1]: the program's source
// index.  A batch of B entries is one record of N = B FE flows, as in
// transition.cu, with live [B] (null: every entry steps).
extern "C" int roce_transition(const RoceParams* p, const RoceFlowPtrs* in,
                               const RoceMsgPtrs* due, const bool* sendable,
                               const bool* eff_nic, const bool* live,
                               const int* act, const int* by_src,
                               const int* src_sorted, const int* blocks,
                               const RoceFlowPtrs* out,
                               const RoceOut* o, cudaStream_t stream) {
  if (p->NR <= 0 || p->FE <= 0 || p->N % p->FE != 0)
    return (int)cudaErrorInvalidValue;
  if ((act == nullptr) != (sendable != nullptr) ||
      (act == nullptr && p->L != p->N) ||
      (act != nullptr && o->done_lane == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p->L <= 0) return 0;
  size_t smem = act != nullptr && p->L <= kSlateSmem ? sizeof(int) * p->L : 0;
  int grid = p->NB > 0 ? p->NB : 1;
  roce_kernel<<<grid, kThreads, smem, stream>>>(
      *p, *in, *due, sendable, eff_nic, live, act, by_src, src_sorted, blocks,
      *out, *o);
  return (int)cudaGetLastError();
}
