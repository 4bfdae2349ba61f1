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
// Bound on the H100: bytes.  A flow's state is 19 scalars (76 B) and its
// due message 6 (14 B); the launch reads them, sendable and src, and writes
// the state and the two TxPacket rows (~110 B): ~200 B per flow, ~0.2 MB
// per tick at 1024 flows, well under a microsecond at 3.35 TB/s.  Design:
// one thread per flow (no ledgers, so nothing to share within a warp).
// Launch (a) applies the message and timers, writes the committed state,
// stores the next-packet proposal in scratch and does an integer atomicMin
// of its score into best[src] (order-independent, deterministic); launch
// (b) commits the proposal where score == best[src] and the NIC is not
// paused.  Float32 follows the reference as XLA computes it on the CPU:
// built with -fmad=false, the CNP's alpha ewma is the one fmaf, and the
// scalar sums now + c arrive folded from the host: the ACK/NACK deadline
// and the pacing tolerance fused with the tick's product
// (numerics.now_plus), the RTO's re-arm a plain float add.
#include "common.cuh"

struct RoceParams {
  int t, timer_tick, N, L, NH, NR, F;
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

struct RoceScratch {  // per lane but best
  int* best;   // [NH]
  int* score;  // [L]
  float *np_rate, *np_target, *np_bytes_ctr, *np_next_send_ts;
  int* np_b_stage;
};

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

__global__ void roce_apply_kernel(RoceParams p, RoceFlowPtrs in,
                                  RoceMsgPtrs due,
                                  const bool* __restrict__ sendable,
                                  const int* __restrict__ src,
                                  const int* __restrict__ act,
                                  RoceFlowPtrs out, RoceOut o,
                                  RoceScratch sc) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= p.L) return;
  int f = act != nullptr ? act[l] : l;
  if (f >= p.N) {  // a padded lane of the slate: inert
    write_offer(o.tx, l, false, 0, 0, false);
    write_offer(o.probe, l, false, 0, 0, false);
    o.probe_valid[l] = false;
    o.can_tx[l] = false;
    o.done_lane[l] = false;
    return;
  }
  Flow s{in.snd_una[f],      in.psn_next[f],     in.total_pkts[f],
         in.t_stage[f],      in.b_stage[f],      in.entropy[f],
         in.retransmits[f],  in.max_psn[f],      in.rto_fires[f],
         in.gbn_rewinds[f],  in.rate[f],         in.target[f],
         in.alpha[f],        in.bytes_ctr[f],    in.last_rate_ts[f],
         in.last_alpha_ts[f], in.next_send_ts[f], in.rto_deadline[f],
         in.tail_bytes[f]};

  // ---- 1. the due message (roce_on_ack; no-op where invalid) ----
  if (due.valid[f]) {
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
  bool send_ok = sendable == nullptr || sendable[f];  // lanes: released
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

  // ---- 3. next-packet offer (roce_next_packet) ----
  bool window_open = s.psn_next < s.total &&
                     (float)(s.psn_next - s.snd_una) < p.window;
  bool can = s.snd_una < s.total && window_open && p.pace_at >= s.next_send;
  int psn = s.psn_next;
  float size = psn >= s.total - 1 ? s.tail : p.mtu;
  float bctr = s.bytes_ctr + size;
  bool b_hit = bctr >= p.byte_counter;
  int bs = s.b_stage + (int)b_hit;
  float n_rate = s.rate, n_target = s.target;
  if (b_hit) increase(p, s.rate, s.target, s.t_stage, bs, n_rate, n_target);
  bool can_tx = can && send_ok;
  int score = can_tx ? floor_mod(f - p.t, p.NR) : p.NR;

  // ---- write the committed state (the send commits in launch b) ----
  out.snd_una[f] = s.snd_una;
  out.psn_next[f] = s.psn_next;
  out.total_pkts[f] = s.total;
  out.rate[f] = s.rate;
  out.target[f] = s.target;
  out.alpha[f] = s.alpha;
  out.t_stage[f] = s.t_stage;
  out.b_stage[f] = s.b_stage;
  out.bytes_ctr[f] = s.bytes_ctr;
  out.last_rate_ts[f] = s.last_rate;
  out.last_alpha_ts[f] = s.last_alpha;
  out.next_send_ts[f] = s.next_send;
  out.rto_deadline[f] = s.rto_dl;
  out.entropy[f] = s.entropy;
  out.retransmits[f] = s.retx;
  out.tail_bytes[f] = s.tail;
  out.max_psn[f] = s.max_psn;
  out.rto_fires[f] = s.rto_fires;
  out.gbn_rewinds[f] = s.gbn;

  write_offer(o.tx, l, can, psn, s.entropy, can && psn < s.max_psn);
  // RoCEv2 sends no probes; the timer's empty slot carries the entropy
  write_offer(o.probe, l, false, 0, p.timer_tick ? s.entropy : 0, false);
  o.probe_valid[l] = false;
  o.can_tx[l] = can_tx;
  if (o.done_lane != nullptr) o.done_lane[l] = s.snd_una >= s.total;

  sc.score[l] = score;
  sc.np_rate[l] = n_rate;
  sc.np_target[l] = n_target;
  sc.np_b_stage[l] = bs;
  sc.np_bytes_ctr[l] = b_hit ? 0.0f : bctr;
  sc.np_next_send_ts[l] = p.now + size / fmaxf(n_rate, p.eps);
  atomicMin(&sc.best[src[f]], score);
}

__global__ void roce_commit_kernel(RoceParams p, const int* __restrict__ src,
                                   const bool* __restrict__ eff_nic,
                                   const int* __restrict__ act,
                                   RoceFlowPtrs out, RoceOut o,
                                   RoceScratch sc) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= p.L) return;
  int f = act != nullptr ? act[l] : l;
  if (f >= p.N) {  // a padded lane
    o.sel[l] = false;
    return;
  }
  int h = src[f];
  bool sel = o.can_tx[l] && sc.score[l] == sc.best[h] &&
             !(eff_nic != nullptr && eff_nic[h]);
  o.sel[l] = sel;
  if (!sel) return;
  int psn = out.psn_next[f];
  out.psn_next[f] = psn + 1;
  if (psn + 1 > out.max_psn[f]) out.max_psn[f] = psn + 1;
  out.rate[f] = sc.np_rate[l];
  out.target[f] = sc.np_target[l];
  out.b_stage[f] = sc.np_b_stage[l];
  out.bytes_ctr[f] = sc.np_bytes_ctr[l];
  out.next_send_ts[f] = sc.np_next_send_ts[l];
}

}  // namespace

// sendable: [N] on the dense program (act null, L = N); null under the
// active set, whose lanes are released by construction (act: [L]).
extern "C" int roce_transition(const RoceParams* p, const RoceFlowPtrs* in,
                               const RoceMsgPtrs* due, const bool* sendable,
                               const int* src, const bool* eff_nic,
                               const int* act, const RoceFlowPtrs* out,
                               const RoceOut* o, const RoceScratch* sc,
                               cudaStream_t stream) {
  if ((act == nullptr) != (sendable != nullptr) ||
      (act == nullptr && p->L != p->N) ||
      (act != nullptr && o->done_lane == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p->L <= 0) return 0;
  // best[] starts at 0x7f7f7f7f, above every score (<= NR)
  cudaError_t err = cudaMemsetAsync(sc->best, 0x7f, sizeof(int) * p->NH,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  int blocks = (p->L + 255) / 256;
  roce_apply_kernel<<<blocks, 256, 0, stream>>>(*p, *in, *due, sendable, src,
                                                act, *out, *o, *sc);
  roce_commit_kernel<<<blocks, 256, 0, stream>>>(*p, src, eff_nic, act, *out,
                                                 *o, *sc);
  return (int)cudaGetLastError();
}
