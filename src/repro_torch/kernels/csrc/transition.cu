// STrack per-flow transitions of the fabric tick: apply the due SACK
// (flow_on_sack), run the timer sweep on timer ticks (flow_on_timer plus
// the probe gate), offer the next packet (flow_next_packet), and arbitrate
// each NIC round-robin, committing only the winner's send.  Under PFC
// (eff_nic, the NICs' effective pause mask; null on lossy queues) a probe
// of a paused NIC is withheld with its timer state, and a paused NIC's
// winner commits nothing.
//
// Replaces: repro/kernels/fabric_kernels.py flow_transition_kernel (:191)
// -> fused_stage_kernel (Pallas, pallas_call at :176), running
// repro/sim/fabric.py dense_trans_core (:1079), and active_trans_core
// (:1120) under the active set, over the STrack protocol
// (repro/core/{cc,lb,reliability,transport}.py).
//
// Lanes: the dense program's lane l is flow l (act null, L = N).  Under
// the active set lane l steps flow act[l] of the slate (ascending flow
// ids, padded with N): it reads and writes that row of the [N] flow record
// IN PLACE (in and out are the same record) and that row of the due SACK
// slot, and its round-robin score is (act[l] - t) % NR, segment-minimised
// over its flow's source; a padded lane (act[l] == N) is inert: it writes
// zero offers, no row, and is never selected.  The per-lane outputs and
// the scratch are indexed by lane; done_lane[l] is the lane's flow done
// after the step.  A row is read and written by its own warp only, so the
// in-place update needs no ordering between warps.
//
// Bound on the H100: bytes.  At perm1024 (N = 1024 flows) each flow's
// state is read and written once: two 512-entry bool ledgers (1 KB), a
// 64-entry int8 spray bitmap, ~30 scalars and the due SACK (64 bools + 9
// scalars), about 1.4 KB in and 1.3 KB out per flow, ~2.8 MB per tick:
// ~0.8 us at 3.35 TB/s.  Design: one warp per flow.  Each 512-entry
// ledger is packed into 16 words with __ballot_sync (lane l reads entry
// 32k + l: 32 consecutive bytes per warp instruction, coalesced), so
// every shift / any / first-set / last-set / popcount of the reference
// becomes word arithmetic, __ffs, __clz and __popc on registers that all
// lanes hold alike; the scalar STrack logic then runs warp-uniform.  The
// NIC arbitration is a segment-min: launch (a) does an integer atomicMin
// of each flow's score into best[src] (order-independent, deterministic);
// launch (b) commits the next-packet proposal where score == best.
#include "common.cuh"

constexpr int W = 512;       // REORDER_WINDOW
constexpr int NW = W / 32;   // words per ledger
constexpr int MAXP = 256;    // largest max_paths supported
constexpr int PW = MAXP / 32;

struct TransParams {
  int t, timer_tick, N, L, NH, NR, P, B;
  float now, probe_at, rto_at;
  float mtu, tq, th, ewma_keep, ewma, beta, alpha, gamma, eta;
  float max_cwnd, min_cwnd, max_cwnd_div8, mtu_recip, two_base_rtt;
  float reset_after, min_ooo, eps;
};

struct FlowPtrs {
  // CCState
  float *cwnd, *base_rtt, *avg_delay, *last_decrease_ts, *last_selfai_ts,
      *achieved_bdp_pkts, *rx_count_bytes, *rxcount_clear_ts;
  // SprayState
  int8_t* bitmap;  // [N, P]
  int *rr, *next_path_id;
  float* last_reset_ts;
  // RelState
  int* epsn;
  bool *sacked, *claimed;  // [N, W]
  int *psn_next, *total_pkts;
  float *tail_bytes, *bytes_sent, *bytes_recvd_seen, *bytes_claimed;
  bool* in_recovery;
  int* recover_high;
  float *probe_deadline, *rto_deadline, *done_ts;
  int *rto_fires, *recoveries;
};

struct SackPtrs {
  const bool* valid;
  const int *epsn, *sack_base;
  const bool* sack_bits;  // [N, B]
  const float* bytes_recvd;
  const int* ooo_cnt;
  const bool* ecn;
  const int* entropy;
  const float* ts;
  const bool* probe_reply;
};

struct TxPtrs {
  bool* valid;
  int *psn, *entropy;
  bool *is_rtx, *is_probe;
};

struct TransOut {  // [L] each
  TxPtrs tx, probe;
  bool *probe_valid, *sel, *can_tx;
  bool* done_lane;  // null on the dense program
};

struct TransScratch {  // per lane but best
  int* best;       // [NH]
  int* score;      // [L]
  int* np_psn_next;
  float* np_bytes_sent;
  int* np_clear;   // claimed bit the send clears, -1 for none
  uint32_t* np_bitmap;  // [L, PW]
  int* np_rr;
  float* np_last_reset;
};

namespace {

// ---- 512-bit ledgers held as 16 words, bit j of entry j ----------------
struct Bits {
  uint32_t w[NW];
};

__device__ __forceinline__ Bits load_bits(const bool* row, int lane) {
  Bits b;
#pragma unroll
  for (int k = 0; k < NW; ++k) b.w[k] = __ballot_sync(FULL_MASK, row[32 * k + lane]);
  return b;
}

__device__ __forceinline__ void store_bits(bool* row, const Bits& b, int lane) {
#pragma unroll
  for (int k = 0; k < NW; ++k) row[32 * k + lane] = (b.w[k] >> lane) & 1u;
}

__device__ __forceinline__ bool bit_at(const Bits& b, int j) {
  return (b.w[j >> 5] >> (j & 31)) & 1u;
}

__device__ __forceinline__ int popc(const Bits& b) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) n += __popc(b.w[k]);
  return n;
}

__device__ __forceinline__ bool any_bits(const Bits& b) {
  uint32_t o = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) o |= b.w[k];
  return o != 0;
}

__device__ __forceinline__ int first_set(const Bits& b) {  // 0 when none
  for (int k = 0; k < NW; ++k)
    if (b.w[k]) return 32 * k + __ffs(b.w[k]) - 1;
  return 0;
}

__device__ __forceinline__ int last_set_plus1(const Bits& b) {  // 0 if none
  for (int k = NW - 1; k >= 0; --k)
    if (b.w[k]) return 32 * k + 32 - __clz(b.w[k]);
  return 0;
}

// entries j < a (a clamped to [0, W])
__device__ __forceinline__ uint32_t prefix_word(int a, int k) {
  int lo = 32 * k;
  if (a >= lo + 32) return FULL_MASK;
  if (a <= lo) return 0u;
  return (1u << (a - lo)) - 1u;
}

// entry j <- entry j + s, zero-filled (the reference's _shift_left)
__device__ __forceinline__ Bits shift_left(const Bits& b, int s) {
  Bits r;
  int ws = s >> 5, bs = s & 31;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    int k0 = k + ws, k1 = k + ws + 1;
    uint32_t lo = k0 < NW ? b.w[k0] : 0u;
    uint32_t hi = k1 < NW ? b.w[k1] : 0u;
    r.w[k] = bs ? ((lo >> bs) | (hi << (32 - bs))) : lo;
  }
  return r;
}

// the 64 SACK bits, as one 64-bit value, placed at entries [s, s + 64)
__device__ __forceinline__ uint32_t bits64_at(uint64_t v, int x) {
  if (x <= -32 || x >= 64) return 0u;
  if (x >= 0) return (uint32_t)(v >> x);
  return (uint32_t)(v << (-x));
}

struct CC {
  float cwnd, base_rtt, avg_delay, last_dec, last_ai, achieved, rx, clear_ts;
};
struct Spray {
  uint32_t bm[PW];
  int rr, next_pid;
  float last_reset;
};
struct Rel {
  int epsn, psn_next, total, recover_high, rto_fires, recoveries;
  float tail, sent, seen, claimed_b, probe_dl, rto_dl, done_ts;
  bool in_rec;
  Bits sacked, claimed;
};

__device__ __forceinline__ bool spray_bit(const Spray& s, int j) {
  return (s.bm[j >> 5] >> (j & 31)) & 1u;
}

__device__ float mask_wire_bytes(const Bits& mask, int epsn, const Rel& r,
                                 const TransParams& p) {
  float n = (float)popc(mask);
  int tail_rel = r.total - 1 - epsn;
  bool tail_in = tail_rel >= 0 && tail_rel < W;
  bool flag = tail_in && bit_at(mask, clampi(tail_rel, 0, W - 1));
  return n * p.mtu - (flag ? (p.mtu - r.tail) : 0.0f);
}

__device__ void enter_recovery(Rel& r, int high, bool enter,
                               const TransParams& p) {
  high = max(r.recover_high, high);
  int a = clampi(high - r.epsn, 0, W);
  int b = clampi(r.psn_next - r.epsn, 0, W);
  Bits lost;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    lost.w[k] = enter ? (prefix_word(a, k) & prefix_word(b, k) &
                         ~r.sacked.w[k] & ~r.claimed.w[k])
                      : 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.claimed.w[k] |= lost.w[k];
  r.claimed_b = r.claimed_b + mask_wire_bytes(lost, r.epsn, r, p);
  r.in_rec = r.in_rec || enter;
  if (enter) r.recover_high = high;
}

// choose_path: returns the entropy; s becomes the committed spray state
__device__ int choose_path(Spray& s, float cwnd, const TransParams& p) {
  bool do_reset = (p.now - s.last_reset) > p.reset_after;
  if (do_reset) {
#pragma unroll
    for (int k = 0; k < PW; ++k) s.bm[k] = 0u;
    s.last_reset = p.now;
  }
  int paths = clampi((int)(2.0f * cwnd), 8, p.P);
  int c0 = floor_mod(s.rr + 1, paths);
  bool c0_marked = spray_bit(s, c0);
  Spray cl = s;
  cl.bm[c0 >> 5] &= ~(1u << (c0 & 31));
  int k = 0;
  for (int i = 1; i < p.P; ++i) {
    if (!spray_bit(cl, floor_mod(s.rr + 1 + i, paths))) {
      k = i;
      break;
    }
  }
  int scanned = c0_marked ? floor_mod(s.rr + 1 + k, paths) : c0;
  bool pinned = s.next_pid >= 0;
  int rr_new = pinned ? s.next_pid : scanned;
  if (!pinned) {
#pragma unroll
    for (int j = 0; j < PW; ++j) s.bm[j] = cl.bm[j];
  }
  s.rr = rr_new;
  s.next_pid = -1;
  return rr_new;
}

__device__ void on_sack(CC& cc, Spray& sp, Rel& r, int f, const SackPtrs& d,
                        uint64_t bits, const TransParams& p) {
  float measured = p.now - d.ts[f];
  float base_rtt = fminf(cc.base_rtt, measured);
  float qdelay = measured - base_rtt;
  bool ecn = d.ecn[f], probe_reply = d.probe_reply[f];

  if (!probe_reply) {  // update_ecn_bitmap
    int pid = d.entropy[f];
    if (pid >= 0 && pid < p.P) {
      uint32_t m = 1u << (pid & 31);
      sp.bm[pid >> 5] = ecn ? (sp.bm[pid >> 5] | m) : (sp.bm[pid >> 5] & ~m);
    }
    sp.next_pid = ecn ? -1 : pid;
  }

  // ---- rel_on_sack ----
  bool done = r.epsn >= r.total;
  bool probe_loss = probe_reply && (qdelay < p.two_base_rtt) &&
                    (cc.achieved == 0.0f) && !done;
  int shift = clampi(d.epsn[f] - r.epsn, 0, W);
  bool advanced = shift > 0;
  Bits unclaim_out;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    unclaim_out.w[k] = r.claimed.w[k] & prefix_word(shift, k);
  int old_epsn = r.epsn;
  float claimed_b = r.claimed_b - mask_wire_bytes(unclaim_out, old_epsn, r, p);
  r.sacked = shift_left(r.sacked, shift);
  r.claimed = shift_left(r.claimed, shift);
  r.epsn = old_epsn + shift;

  int off = d.sack_base[f] - r.epsn;
  int s0 = clampi(off, 0, W);
  Bits placed, unclaim_sel;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint32_t pw = off >= 0 ? bits64_at(bits, 32 * k - s0) : 0u;
    uint32_t newly = pw & ~r.sacked.w[k];
    placed.w[k] = pw;
    unclaim_sel.w[k] = newly & r.claimed.w[k];
  }
  claimed_b = claimed_b - mask_wire_bytes(unclaim_sel, r.epsn, r, p);
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    r.sacked.w[k] |= placed.w[k];
    r.claimed.w[k] &= ~unclaim_sel.w[k];
  }
  float recvd = d.bytes_recvd[f];
  float acked = fmaxf(0.0f, recvd - r.seen);
  r.seen = fmaxf(r.seen, recvd);
  r.claimed_b = claimed_b;
  r.probe_dl = p.probe_at;
  if (advanced) r.rto_dl = p.rto_at;

  float thresh = fmaxf(cc.cwnd, p.min_ooo);
  bool any_s = any_bits(r.sacked);
  int high_sacked = r.epsn + (any_s ? last_set_plus1(r.sacked) : 0);
  bool ooo_loss = ((float)d.ooo_cnt[f] > thresh) && d.valid[f];
  bool enter = ooo_loss || probe_loss;
  int high = probe_loss ? r.psn_next : (any_s ? high_sacked : r.epsn);
  bool fresh = enter && !r.in_rec;
  enter_recovery(r, high, enter, p);
  r.recoveries += (int)fresh;
  bool exit_rec = r.in_rec && (r.epsn >= r.recover_high);
  r.in_rec = r.in_rec && !exit_rec;
  if (exit_rec) r.recover_high = -1;
  if (r.epsn >= r.total && r.done_ts < 0.0f) r.done_ts = p.now;

  // ---- update_achieved_bdp ----
  cc.base_rtt = base_rtt;
  bool can_clear = (p.now - cc.clear_ts) > (cc.base_rtt + p.tq);
  float rx = cc.rx + (probe_reply ? 0.0f : acked);
  if (can_clear) cc.achieved = rx * p.mtu_recip;
  cc.rx = can_clear ? 0.0f : rx;
  if (can_clear) cc.clear_ts = p.now;

  // ---- adjust_cwnd ----
  bool can_dec = (p.now - cc.last_dec) > cc.base_rtt;
  bool can_fair = (p.now - cc.last_ai) > cc.base_rtt;
  float avg = __fmaf_rn(cc.avg_delay, p.ewma_keep, p.ewma * qdelay);
  bool b1 = !ecn && (qdelay > p.th);
  bool b2 = !b1 && !ecn && (qdelay < p.tq);
  bool b3 = !b1 && !b2 && can_dec && (avg > p.tq);
  bool b3a = b3 && (qdelay > p.th) && (cc.achieved < p.max_cwnd_div8);
  bool b3b = b3 && !b3a && (qdelay > p.tq);
  float c = cc.cwnd;
  if (b1) c = c + p.beta / c;
  if (b2) c = c + (p.alpha * (p.tq - qdelay)) / c;
  if (b3a) c = cc.achieved;
  if (b3b)
    c = cc.cwnd *
        fmaxf(1.0f - (p.gamma * (avg - p.tq)) / fmaxf(avg, p.eps), 0.5f);
  if (b3a || b3b) cc.last_dec = p.now;
  if (can_fair) {
    c = c + p.eta;
    cc.last_ai = p.now;
  }
  cc.cwnd = fminf(fmaxf(c, p.min_cwnd), p.max_cwnd);
  cc.avg_delay = avg;
}

__device__ __forceinline__ int load_spray(Spray& s, const int8_t* row,
                                          int lane, int P) {
#pragma unroll
  for (int k = 0; k < PW; ++k) {
    int j = 32 * k + lane;
    s.bm[k] = __ballot_sync(FULL_MASK, j < P && row[j] != 0);
  }
  return 0;
}

__device__ __forceinline__ void write_offer(TxPtrs tx, int l, bool valid,
                                            int psn, int entropy,
                                            bool is_rtx, bool is_probe) {
  tx.valid[l] = valid;
  tx.psn[l] = psn;
  tx.entropy[l] = entropy;
  tx.is_rtx[l] = is_rtx;
  tx.is_probe[l] = is_probe;
}

__global__ void apply_kernel(TransParams p, FlowPtrs in, SackPtrs due,
                             const bool* __restrict__ sendable,
                             const int* __restrict__ src,
                             const bool* __restrict__ eff_nic,
                             const int* __restrict__ act, FlowPtrs out,
                             TransOut o, TransScratch sc) {
  int l = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // one warp a lane
  int lane = threadIdx.x & 31;
  if (l >= p.L) return;  // whole warps exit together
  int f = act != nullptr ? act[l] : l;
  if (f >= p.N) {  // a padded lane of the slate: inert
    if (lane == 0) {
      write_offer(o.tx, l, false, 0, 0, false, false);
      write_offer(o.probe, l, false, 0, 0, false, false);
      o.probe_valid[l] = false;
      o.can_tx[l] = false;
      o.done_lane[l] = false;
    }
    return;
  }

  CC cc{in.cwnd[f], in.base_rtt[f], in.avg_delay[f], in.last_decrease_ts[f],
        in.last_selfai_ts[f], in.achieved_bdp_pkts[f], in.rx_count_bytes[f],
        in.rxcount_clear_ts[f]};
  Spray sp;
  load_spray(sp, in.bitmap + (size_t)f * p.P, lane, p.P);
  sp.rr = in.rr[f];
  sp.next_pid = in.next_path_id[f];
  sp.last_reset = in.last_reset_ts[f];
  Rel r;
  r.epsn = in.epsn[f];
  r.psn_next = in.psn_next[f];
  r.total = in.total_pkts[f];
  r.recover_high = in.recover_high[f];
  r.rto_fires = in.rto_fires[f];
  r.recoveries = in.recoveries[f];
  r.tail = in.tail_bytes[f];
  r.sent = in.bytes_sent[f];
  r.seen = in.bytes_recvd_seen[f];
  r.claimed_b = in.bytes_claimed[f];
  r.probe_dl = in.probe_deadline[f];
  r.rto_dl = in.rto_deadline[f];
  r.done_ts = in.done_ts[f];
  r.in_rec = in.in_recovery[f];
  r.sacked = load_bits(in.sacked + (size_t)f * W, lane);
  r.claimed = load_bits(in.claimed + (size_t)f * W, lane);

  // ---- 1. the due SACK (flow_on_sack; no-op where invalid) ----
  if (due.valid[f]) {
    const bool* brow = due.sack_bits + (size_t)f * p.B;
    uint32_t lo = __ballot_sync(FULL_MASK, lane < p.B && brow[lane]);
    uint32_t hi = __ballot_sync(FULL_MASK, lane + 32 < p.B && brow[lane + 32]);
    on_sack(cc, sp, r, f, due, ((uint64_t)hi << 32) | lo, p);
  }

  // ---- 2. timer sweep on timer ticks (committed for released flows) ----
  bool send_ok = sendable == nullptr || sendable[f];  // lanes: released
  bool pvalid = false, blocked = false;
  int p_entropy = 0, p_psn = 0;
  if (p.timer_tick) {
    Rel rt = r;
    bool active = rt.epsn < rt.total;
    bool rto = active && (p.now >= rt.rto_dl);
    enter_recovery(rt, rt.psn_next, rto, p);
    if (rto) rt.rto_dl = p.rto_at;
    rt.rto_fires += (int)rto;
    bool probe = active && !rto && (p.now >= rt.probe_dl);
    if (probe) rt.probe_dl = p.probe_at;
    Spray st = sp;
    p_entropy = choose_path(st, cc.cwnd, p);
    p_psn = rt.epsn;
    pvalid = probe && (r.sent > 0.0f);  // probes only once data was sent
    // a paused NIC delays the probe: its timer state is not committed
    blocked = pvalid && eff_nic != nullptr && eff_nic[src[f]];
    if (send_ok && !blocked) {
      r = rt;
      if (probe) sp = st;
    }
  }
  bool probe_valid = pvalid && send_ok && !blocked;

  // ---- 3. next-packet offer (rel_next_psn + choose_path) ----
  bool has_rtx = any_bits(r.claimed);
  float inflight = (r.sent - r.seen) - r.claimed_b;
  bool window_ok = inflight < cc.cwnd * p.mtu;
  bool seq_ok = (r.psn_next - r.epsn) < W;
  bool has_new = (r.psn_next < r.total) && seq_ok;
  bool valid = (r.epsn < r.total) && window_ok && (has_rtx || has_new);
  int rtx_rel = first_set(r.claimed);
  bool use_rtx = valid && has_rtx;
  int psn = use_rtx ? r.epsn + rtx_rel : r.psn_next;
  Spray sn = sp;
  int entropy = choose_path(sn, cc.cwnd, p);
  bool can_tx = valid && send_ok;
  int score = can_tx ? floor_mod(f - p.t, p.NR) : p.NR;

  // ---- write the committed state (the send commits in launch b) ----
  store_bits(out.sacked + (size_t)f * W, r.sacked, lane);
  store_bits(out.claimed + (size_t)f * W, r.claimed, lane);
  for (int j = lane; j < p.P; j += 32)
    out.bitmap[(size_t)f * p.P + j] = (int8_t)spray_bit(sp, j);
  if (lane == 0) {
    out.cwnd[f] = cc.cwnd;
    out.base_rtt[f] = cc.base_rtt;
    out.avg_delay[f] = cc.avg_delay;
    out.last_decrease_ts[f] = cc.last_dec;
    out.last_selfai_ts[f] = cc.last_ai;
    out.achieved_bdp_pkts[f] = cc.achieved;
    out.rx_count_bytes[f] = cc.rx;
    out.rxcount_clear_ts[f] = cc.clear_ts;
    out.rr[f] = sp.rr;
    out.next_path_id[f] = sp.next_pid;
    out.last_reset_ts[f] = sp.last_reset;
    out.epsn[f] = r.epsn;
    out.psn_next[f] = r.psn_next;
    out.total_pkts[f] = r.total;
    out.tail_bytes[f] = r.tail;
    out.bytes_sent[f] = r.sent;
    out.bytes_recvd_seen[f] = r.seen;
    out.bytes_claimed[f] = r.claimed_b;
    out.in_recovery[f] = r.in_rec;
    out.recover_high[f] = r.recover_high;
    out.probe_deadline[f] = r.probe_dl;
    out.rto_deadline[f] = r.rto_dl;
    out.done_ts[f] = r.done_ts;
    out.rto_fires[f] = r.rto_fires;
    out.recoveries[f] = r.recoveries;

    write_offer(o.tx, l, valid, psn, entropy, use_rtx, false);
    write_offer(o.probe, l, pvalid, p_psn, p_entropy, false, pvalid);
    o.probe_valid[l] = probe_valid;
    o.can_tx[l] = can_tx;
    if (o.done_lane != nullptr) o.done_lane[l] = r.epsn >= r.total;

    sc.score[l] = score;
    sc.np_psn_next[l] = (valid && !has_rtx) ? r.psn_next + 1 : r.psn_next;
    float wire = (psn >= r.total - 1) ? r.tail : p.mtu;
    sc.np_bytes_sent[l] = r.sent + (valid ? wire : 0.0f);
    sc.np_clear[l] = use_rtx ? rtx_rel : -1;
#pragma unroll
    for (int k = 0; k < PW; ++k) sc.np_bitmap[(size_t)l * PW + k] = sn.bm[k];
    sc.np_rr[l] = sn.rr;
    sc.np_last_reset[l] = sn.last_reset;
    atomicMin(&sc.best[src[f]], score);
  }
}

__global__ void commit_kernel(TransParams p, const int* __restrict__ src,
                              const bool* __restrict__ eff_nic,
                              const int* __restrict__ act, FlowPtrs out,
                              TransOut o, TransScratch sc) {
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
  out.psn_next[f] = sc.np_psn_next[l];
  out.bytes_sent[f] = sc.np_bytes_sent[l];
  int clr = sc.np_clear[l];
  if (clr >= 0) out.claimed[(size_t)f * W + clr] = false;
  for (int j = 0; j < p.P; ++j)
    out.bitmap[(size_t)f * p.P + j] =
        (int8_t)((sc.np_bitmap[(size_t)l * PW + (j >> 5)] >> (j & 31)) & 1u);
  out.rr[f] = sc.np_rr[l];
  out.next_path_id[f] = -1;
  out.last_reset_ts[f] = sc.np_last_reset[l];
}

}  // namespace

// sendable: [N] on the dense program (act null, L = N); null under the
// active set, whose lanes are released by construction (act: [L]).
extern "C" int strack_transition(const TransParams* p, const FlowPtrs* in,
                                 const SackPtrs* due, const bool* sendable,
                                 const int* src, const bool* eff_nic,
                                 const int* act, const FlowPtrs* out,
                                 const TransOut* o, const TransScratch* sc,
                                 cudaStream_t stream) {
  if (p->P > MAXP || p->B > 64) return (int)cudaErrorInvalidValue;
  if ((act == nullptr) != (sendable != nullptr) ||
      (act == nullptr && p->L != p->N) ||
      (act != nullptr && o->done_lane == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p->L <= 0) return 0;
  // best[] starts at INT_MAX-ish (0x7f7f7f7f), above every score (<= NR)
  cudaError_t err = cudaMemsetAsync(sc->best, 0x7f, sizeof(int) * p->NH,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = 8;
  int blocks = (p->L + warps_per_block - 1) / warps_per_block;
  apply_kernel<<<blocks, 32 * warps_per_block, 0, stream>>>(
      *p, *in, *due, sendable, src, eff_nic, act, *out, *o, *sc);
  commit_kernel<<<(p->L + 255) / 256, 256, 0, stream>>>(
      *p, src, eff_nic, act, *out, *o, *sc);
  return (int)cudaGetLastError();
}
