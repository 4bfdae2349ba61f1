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
// slot, and its round-robin score is (act[l] - t) % NR, minimised over its
// flow's source; a padded lane (act[l] == N) is inert: it writes zero
// offers, no row, and is never selected.  The per-lane outputs are indexed
// by lane; done_lane[l] is the lane's flow done after the step.
//
// A batch of B entries (sim/fabric.py BatchProgram) is one launch: the
// record is [B FE] flows (entry e's flow f at row e FE + f), the source
// index's block table spans the entries (entry e's hosts numbered
// e NH + h, so a NIC's flows never leave one entry), the round-robin score
// reads the flow's index in its entry, and an entry that live[e] marks
// frozen takes no due message and sends nothing, so its rows are written
// back as they were read.
//
// Bound on the H100: bytes.  At perm1024 (N = 1024 flows) each flow's
// state is read and written once: two 512-entry bool ledgers (1 KB), a
// 256-entry int8 spray bitmap, ~30 scalars and the due SACK (64 bools + 9
// scalars), ~2.8 MB per tick: ~0.8 us at 3.35 TB/s.
//
// Design: one launch, no scratch, no global atomics.  A block takes whole
// sources: the program's source index lists the flows by source (by_src,
// a stable sort of src, and src_sorted, their sources) and cuts that list
// into blocks of at most kWarps flows (blocks[b] .. blocks[b + 1]), a
// source with more flows in a block of its own.  The launch's arguments
// are one block of kernel parameters that each block copies to shared
// memory first, one 8-byte word a thread (read from the constant bank one
// after another, they cost the kernel's first build most of its time).  Each flow of a block has a warp,
// which issues all of the flow's loads before any shuffle or vote waits on
// one: its 4-byte scalars one a lane (shuffled out to every lane after),
// each 512-entry ledger 16 bytes a lane, packed into 16 words that lane k
// keeps word k of (the spray bitmap's 8 words likewise, from ballots), so
// every shift / any / first-set / last-set / popcount of the reference is
// a shuffle, a vote or a warp reduction; the scalar STrack logic runs
// warp-uniform, and the path choice scans 32 candidate paths a ballot.
// The NIC arbitration is a minimum in shared memory: each flow's score
// goes into its source's slot with a shared atomicMin; after one
// __syncthreads each warp commits its flow's send from its registers where
// its score is the minimum (every flow of that score, as the reference
// selects ties).  The fields the send does not touch are written before
// the barrier, the rest after it, each once, the scalars one a lane.  A
// source with more flows than kWarps is walked twice by the block's warps:
// once for the minimum, once (recomputing each flow) to commit.  Under the
// active set the block stages the slate in shared memory, finds each of
// its flows' lanes by binary search and hands the live ones to its first
// warps; a grid-strided pass writes the padded lanes' zero outputs.  Two
// blocks fit an SM (64 registers a thread), so that the active set's
// sparse blocks run in fewer waves.
#include "common.cuh"

constexpr int W = 512;       // REORDER_WINDOW
constexpr int NW = W / 32;   // words per ledger
constexpr int MAXP = 256;    // largest max_paths supported
constexpr int PW = MAXP / 32;
constexpr int kWarps = 16;   // flows a block takes (BLOCK_FLOWS)
constexpr int kThreads = 32 * kWarps;
constexpr int kSlateSmem = 8192;  // the largest slate held in shared memory

struct TransParams {
  int t, timer_tick, N, L, NB, NR, P, B;
  int FE;  // flows an entry: N on one program, N / B of a batch's
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

namespace {

// ---- bit sets spread over a warp: lane k < K holds word k (bit i of it
// is entry 32 k + i), the other lanes hold 0.  The 512-entry ledgers
// have K = NW words, the spray bitmap PW.  Every helper is called by the
// whole warp, and returns the same value on every lane unless it says
// otherwise.
__device__ __forceinline__ uint32_t word_of(uint32_t w, int k) {  // k < 32
  return __shfl_sync(FULL_MASK, w, k);
}

template <int K>
__device__ __forceinline__ void store_set(int8_t* row, int n, uint32_t w,
                                          int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = 32 * k + lane;
    const uint32_t v = word_of(w, k);
    if (j < n) row[j] = (int8_t)((v >> lane) & 1u);
  }
}

// A ledger's row of W bools (16-byte aligned) and its words: lane l moves
// entries 16 l .. 16 l + 15 with one 16-byte access, four bools a 32-bit
// word packed to four bits and back.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
}

__device__ __forceinline__ uint32_t unpack4(uint32_t c) {
  return (c & 1u) | ((c & 2u) << 7) | ((c & 4u) << 14) | ((c & 8u) << 21);
}

// the lane's word of a ledger row, from the 16 bytes lane l loaded
// (entries 16 l .. 16 l + 15)
__device__ __forceinline__ uint32_t ledger_words(uint4 v, int lane) {
  const uint32_t c =
      pack4(v.x) | pack4(v.y) << 4 | pack4(v.z) << 8 | pack4(v.w) << 12;
  const uint32_t lo = __shfl_sync(FULL_MASK, c, (2 * lane) & 31);
  const uint32_t hi = __shfl_sync(FULL_MASK, c, (2 * lane + 1) & 31);
  return lane < NW ? lo | hi << 16 : 0u;
}

__device__ __forceinline__ void store_ledger(bool* row, uint32_t w,
                                             int lane) {
  const uint32_t c =
      (__shfl_sync(FULL_MASK, w, lane >> 1) >> (16 * (lane & 1))) & 0xffffu;
  reinterpret_cast<uint4*>(row)[lane] =
      make_uint4(unpack4(c), unpack4(c >> 4), unpack4(c >> 8),
                 unpack4(c >> 12));
}

__device__ __forceinline__ bool bit_at(uint32_t w, int j) {  // any lane's j
  return (word_of(w, j >> 5) >> (j & 31)) & 1u;
}

// w with entry j cleared (j the same on every lane)
__device__ __forceinline__ uint32_t clear_bit(uint32_t w, int j, int lane) {
  return lane == (j >> 5) ? w & ~(1u << (j & 31)) : w;
}

__device__ __forceinline__ int popc(uint32_t w) {
  return (int)__reduce_add_sync(FULL_MASK, (unsigned)__popc(w));
}

__device__ __forceinline__ bool any_bits(uint32_t w) {
  return __any_sync(FULL_MASK, w != 0u);
}

__device__ __forceinline__ int first_set(uint32_t w) {  // 0 when none
  const uint32_t m = __ballot_sync(FULL_MASK, w != 0u);
  const int k = __ffs(m) - 1;
  const uint32_t v = word_of(w, m ? k : 0);
  return m ? 32 * k + __ffs(v) - 1 : 0;
}

__device__ __forceinline__ int last_set_plus1(uint32_t w) {  // 0 if none
  const uint32_t m = __ballot_sync(FULL_MASK, w != 0u);
  const int k = 31 - __clz(m);
  const uint32_t v = word_of(w, m ? k : 0);
  return m ? 32 * k + 32 - __clz(v) : 0;
}

// the lane's word of entries j < a (a in [0, W]; 0 past the ledger)
__device__ __forceinline__ uint32_t prefix_word(int a, int lane) {
  const int lo = 32 * lane;
  if (a >= lo + 32) return FULL_MASK;
  if (a <= lo) return 0u;
  return (1u << (a - lo)) - 1u;
}

// entry j <- entry j + s, zero-filled (the reference's _shift_left), for
// an s in [0, W] the same on every lane
__device__ __forceinline__ uint32_t shift_left(uint32_t w, int s, int lane) {
  const int k0 = lane + (s >> 5), bs = s & 31;
  uint32_t lo = __shfl_sync(FULL_MASK, w, k0 & 31);
  uint32_t hi = __shfl_sync(FULL_MASK, w, (k0 + 1) & 31);
  lo = k0 < NW ? lo : 0u;
  hi = k0 + 1 < NW ? hi : 0u;
  return bs ? __funnelshift_r(lo, hi, bs) : lo;
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
  uint32_t bm;  // the ECN bitmap, spread over lanes 0 .. PW-1
  int rr, next_pid;
  float last_reset;
};
struct Rel {
  int epsn, psn_next, total, recover_high, rto_fires, recoveries;
  float tail, sent, seen, claimed_b, probe_dl, rto_dl, done_ts;
  bool in_rec;
  uint32_t sacked, claimed;  // spread over lanes 0 .. NW-1
};

__device__ __forceinline__ float mask_wire_bytes(uint32_t mask, int epsn,
                                                 const Rel& r,
                                                 const TransParams& p) {
  float n = (float)popc(mask);
  int tail_rel = r.total - 1 - epsn;
  bool tail_in = tail_rel >= 0 && tail_rel < W;
  bool flag = bit_at(mask, clampi(tail_rel, 0, W - 1)) && tail_in;
  return n * p.mtu - (flag ? (p.mtu - r.tail) : 0.0f);
}

__device__ __forceinline__ void enter_recovery(Rel& r, int high, bool enter,
                                               const TransParams& p,
                                               int lane) {
  high = max(r.recover_high, high);
  int a = clampi(high - r.epsn, 0, W);
  int b = clampi(r.psn_next - r.epsn, 0, W);
  uint32_t lost = enter ? (prefix_word(a, lane) & prefix_word(b, lane) &
                           ~r.sacked & ~r.claimed)
                        : 0u;
  r.claimed |= lost;
  r.claimed_b = r.claimed_b + mask_wire_bytes(lost, r.epsn, r, p);
  r.in_rec = r.in_rec || enter;
  if (enter) r.recover_high = high;
}

// choose_path: returns the entropy; s becomes the committed spray state.
// The reference scans i = 1 .. P-1 for the first unmarked path
// (rr + 1 + i) % paths once the round-robin's next path is marked; the
// warp tests 32 candidates a ballot.
__device__ __forceinline__ int choose_path(Spray& s, float cwnd,
                                           const TransParams& p, int lane) {
  bool do_reset = (p.now - s.last_reset) > p.reset_after;
  if (do_reset) {
    s.bm = 0u;
    s.last_reset = p.now;
  }
  int paths = clampi((int)(2.0f * cwnd), 8, p.P);
  int c0 = floor_mod(s.rr + 1, paths);
  bool c0_marked = bit_at(s.bm, c0);
  uint32_t cl = clear_bit(s.bm, c0, lane);
  int scanned = c0;
  if (c0_marked) {
    int k = 0;  // none unmarked: the reference's argmax of all-false
    for (int base = 1; base < p.P; base += 32) {
      int i = base + lane;
      bool marked = bit_at(cl, floor_mod(s.rr + 1 + i, paths));
      uint32_t m = __ballot_sync(FULL_MASK, i < p.P && !marked);
      if (m) {
        k = base + __ffs(m) - 1;
        break;
      }
    }
    scanned = floor_mod(s.rr + 1 + k, paths);
  }
  bool pinned = s.next_pid >= 0;
  int rr_new = pinned ? s.next_pid : scanned;
  if (!pinned) s.bm = cl;
  s.rr = rr_new;
  s.next_pid = -1;
  return rr_new;
}

struct Due {  // the flow's row of the due SACK slot
  bool valid, ecn, probe_reply;
  int epsn, sack_base, ooo_cnt, entropy;
  float bytes_recvd, ts;
};

__device__ __forceinline__ void on_sack(CC& cc, Spray& sp, Rel& r,
                                        const Due& d, uint64_t bits,
                                        const TransParams& p, int lane) {
  float measured = p.now - d.ts;
  float base_rtt = fminf(cc.base_rtt, measured);
  float qdelay = measured - base_rtt;
  bool ecn = d.ecn, probe_reply = d.probe_reply;

  if (!probe_reply) {  // update_ecn_bitmap
    int pid = d.entropy;
    if (pid >= 0 && pid < p.P && lane == (pid >> 5)) {
      uint32_t m = 1u << (pid & 31);
      sp.bm = ecn ? (sp.bm | m) : (sp.bm & ~m);
    }
    sp.next_pid = ecn ? -1 : pid;
  }

  // ---- rel_on_sack ----
  bool done = r.epsn >= r.total;
  bool probe_loss = probe_reply && (qdelay < p.two_base_rtt) &&
                    (cc.achieved == 0.0f) && !done;
  int shift = clampi(d.epsn - r.epsn, 0, W);
  bool advanced = shift > 0;
  uint32_t unclaim_out = r.claimed & prefix_word(shift, lane);
  int old_epsn = r.epsn;
  float claimed_b = r.claimed_b - mask_wire_bytes(unclaim_out, old_epsn, r, p);
  r.sacked = shift_left(r.sacked, shift, lane);
  r.claimed = shift_left(r.claimed, shift, lane);
  r.epsn = old_epsn + shift;

  int off = d.sack_base - r.epsn;
  int s0 = clampi(off, 0, W);
  uint32_t placed = off >= 0 && lane < NW ? bits64_at(bits, 32 * lane - s0)
                                           : 0u;
  uint32_t unclaim_sel = placed & ~r.sacked & r.claimed;
  claimed_b = claimed_b - mask_wire_bytes(unclaim_sel, r.epsn, r, p);
  r.sacked |= placed;
  r.claimed &= ~unclaim_sel;
  float acked = fmaxf(0.0f, d.bytes_recvd - r.seen);
  r.seen = fmaxf(r.seen, d.bytes_recvd);
  r.claimed_b = claimed_b;
  r.probe_dl = p.probe_at;
  if (advanced) r.rto_dl = p.rto_at;

  float thresh = fmaxf(cc.cwnd, p.min_ooo);
  bool any_s = any_bits(r.sacked);
  int high_sacked = r.epsn + last_set_plus1(r.sacked);
  bool ooo_loss = ((float)d.ooo_cnt > thresh) && d.valid;
  bool enter = ooo_loss || probe_loss;
  int high = probe_loss ? r.psn_next : (any_s ? high_sacked : r.epsn);
  bool fresh = enter && !r.in_rec;
  enter_recovery(r, high, enter, p, lane);
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

// ---- the scalars a warp moves one a lane -------------------------------
// Loads: the record's 4-byte scalars, then the due SACK's.
enum LoadSlot {
  kCwnd, kBaseRtt, kAvgDelay, kLastDec, kLastAi, kAchieved, kRx, kClearTs,
  kRr, kNextPid, kLastReset, kEpsn, kPsnNext, kTotal, kTail, kSent, kSeen,
  kClaimedB, kRecoverHigh, kProbeDl, kRtoDl, kDoneTs, kRtoFires, kRecoveries,
  kDueEpsn, kDueBase, kDueRecvd, kDueOoo, kDueEnt, kDueTs, kLoads
};
// Stores before the arbitration: the record's fields the send leaves as
// they are (4-byte scalars by flow, then in_recovery) and the lane's
// outputs but sel; after it, the send's fields and sel.
enum PreSlot {
  pCwnd, pBaseRtt, pAvgDelay, pLastDec, pLastAi, pAchieved, pRx, pClearTs,
  pEpsn, pTotal, pTail, pSeen, pClaimedB, pRecoverHigh, pProbeDl, pRtoDl,
  pDoneTs, pRtoFires, pRecoveries,  // 4 bytes, by flow
  pInRec,                            // 1 byte, by flow
  pTxValid, pTxRtx, pTxProbe, pPValid, pPRtx, pPProbe, pProbeValid, pCanTx,
  pDoneLane,                         // 1 byte, by lane
  pTxPsn, pTxEnt, pPPsn, pPEnt,      // 4 bytes, by lane
  kPre
};
enum PostSlot { qPsnNext, qSent, qRr, qNextPid, qLastReset, qSel, kPost };
constexpr int kRow = 40;  // a warp's staging row in shared memory
static_assert(kLoads <= 32 && kPost <= 32 && kPre <= kRow, "slots");

// The slots' pointers (null: absent), built on the host for each launch.
struct Slots {
  const uint32_t* ld[kLoads];
  void* pre[kPre];
  void* post[kPost];
};

const void* load_ptr(const FlowPtrs& in, const SackPtrs& d, int k) {
  switch (k) {
    case kCwnd: return in.cwnd;
    case kBaseRtt: return in.base_rtt;
    case kAvgDelay: return in.avg_delay;
    case kLastDec: return in.last_decrease_ts;
    case kLastAi: return in.last_selfai_ts;
    case kAchieved: return in.achieved_bdp_pkts;
    case kRx: return in.rx_count_bytes;
    case kClearTs: return in.rxcount_clear_ts;
    case kRr: return in.rr;
    case kNextPid: return in.next_path_id;
    case kLastReset: return in.last_reset_ts;
    case kEpsn: return in.epsn;
    case kPsnNext: return in.psn_next;
    case kTotal: return in.total_pkts;
    case kTail: return in.tail_bytes;
    case kSent: return in.bytes_sent;
    case kSeen: return in.bytes_recvd_seen;
    case kClaimedB: return in.bytes_claimed;
    case kRecoverHigh: return in.recover_high;
    case kProbeDl: return in.probe_deadline;
    case kRtoDl: return in.rto_deadline;
    case kDoneTs: return in.done_ts;
    case kRtoFires: return in.rto_fires;
    case kRecoveries: return in.recoveries;
    case kDueEpsn: return d.epsn;
    case kDueBase: return d.sack_base;
    case kDueRecvd: return d.bytes_recvd;
    case kDueOoo: return d.ooo_cnt;
    case kDueEnt: return d.entropy;
    default: return d.ts;
  }
}

void* pre_ptr(const FlowPtrs& out, const TransOut& o, int k) {
  switch (k) {
    case pCwnd: return out.cwnd;
    case pBaseRtt: return out.base_rtt;
    case pAvgDelay: return out.avg_delay;
    case pLastDec: return out.last_decrease_ts;
    case pLastAi: return out.last_selfai_ts;
    case pAchieved: return out.achieved_bdp_pkts;
    case pRx: return out.rx_count_bytes;
    case pClearTs: return out.rxcount_clear_ts;
    case pEpsn: return out.epsn;
    case pTotal: return out.total_pkts;
    case pTail: return out.tail_bytes;
    case pSeen: return out.bytes_recvd_seen;
    case pClaimedB: return out.bytes_claimed;
    case pRecoverHigh: return out.recover_high;
    case pProbeDl: return out.probe_deadline;
    case pRtoDl: return out.rto_deadline;
    case pDoneTs: return out.done_ts;
    case pRtoFires: return out.rto_fires;
    case pRecoveries: return out.recoveries;
    case pInRec: return out.in_recovery;
    case pTxValid: return o.tx.valid;
    case pTxRtx: return o.tx.is_rtx;
    case pTxProbe: return o.tx.is_probe;
    case pPValid: return o.probe.valid;
    case pPRtx: return o.probe.is_rtx;
    case pPProbe: return o.probe.is_probe;
    case pProbeValid: return o.probe_valid;
    case pCanTx: return o.can_tx;
    case pDoneLane: return o.done_lane;
    case pTxPsn: return o.tx.psn;
    case pTxEnt: return o.tx.entropy;
    case pPPsn: return o.probe.psn;
    default: return o.probe.entropy;
  }
}

void* post_ptr(const FlowPtrs& out, const TransOut& o, int k) {
  switch (k) {
    case qPsnNext: return out.psn_next;
    case qSent: return out.bytes_sent;
    case qRr: return out.rr;
    case qNextPid: return out.next_path_id;
    case qLastReset: return out.last_reset_ts;
    default: return o.sel;
  }
}

__device__ __forceinline__ uint32_t u(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t u(int x) { return (uint32_t)x; }
__device__ __forceinline__ uint32_t u(bool x) { return x ? 1u : 0u; }

// One flow's step up to the arbitration, warp-uniform (every lane holds
// the same values).
struct Step {
  CC cc;
  Spray sp;  // committed without a send
  Spray sn;  // after the send's path choice
  Rel r;     // committed without a send
  bool valid, use_rtx, pvalid, probe_valid, can_tx, paused;
  int psn, entropy, p_psn, p_entropy, rtx_rel, score;
};

__device__ __forceinline__ void step_flow(
    Step& s, const TransParams& p, const Slots& tb, const FlowPtrs& in,
    const SackPtrs& due, const bool* sendable, const bool* eff_nic,
    const bool* live, int f, int h, int lane) {
  // every load of the flow first (a warp issues in order: a vote or a
  // shuffle on a load's value waits for it), then the votes and shuffles.
  // The 4-byte scalars: one load a lane, shuffled out to every lane.
  const uint32_t v = lane < kLoads ? tb.ld[lane][f] : 0u;
  int8_t bm[PW];
#pragma unroll
  for (int k = 0; k < PW; ++k) {
    const int j = 32 * k + lane;
    bm[k] = j < p.P ? in.bitmap[(size_t)f * p.P + j] : 0;
  }
  const uint4 sk =
      reinterpret_cast<const uint4*>(in.sacked + (size_t)f * W)[lane];
  const uint4 ck =
      reinterpret_cast<const uint4*>(in.claimed + (size_t)f * W)[lane];
  const bool* brow = due.sack_bits + (size_t)f * p.B;
  const bool b_lo = lane < p.B && brow[lane];
  const bool b_hi = lane + 32 < p.B && brow[lane + 32];
  // a frozen entry of a batch neither takes its due message nor sends
  const bool on = live == nullptr || live[f / p.FE];
  const bool in_rec = in.in_recovery[f], valid = due.valid[f] && on;
  const bool ecn = due.ecn[f], probe_reply = due.probe_reply[f];
  s.paused = eff_nic != nullptr ? eff_nic[h] : false;
  // the active set's lanes are released by construction
  const bool send_ok = (sendable != nullptr ? sendable[f] : true) && on;

  auto sh = [&](int k) { return __shfl_sync(FULL_MASK, v, k); };
  auto shf = [&](int k) { return __uint_as_float(sh(k)); };
  CC& cc = s.cc;
  cc = CC{shf(kCwnd), shf(kBaseRtt), shf(kAvgDelay), shf(kLastDec),
          shf(kLastAi), shf(kAchieved), shf(kRx), shf(kClearTs)};
  Spray& sp = s.sp;
  sp.bm = 0u;
#pragma unroll
  for (int k = 0; k < PW; ++k) {
    const uint32_t b = __ballot_sync(FULL_MASK, bm[k] != 0);
    sp.bm = lane == k ? b : sp.bm;
  }
  sp.rr = (int)sh(kRr);
  sp.next_pid = (int)sh(kNextPid);
  sp.last_reset = shf(kLastReset);
  Rel& r = s.r;
  r.epsn = (int)sh(kEpsn);
  r.psn_next = (int)sh(kPsnNext);
  r.total = (int)sh(kTotal);
  r.recover_high = (int)sh(kRecoverHigh);
  r.rto_fires = (int)sh(kRtoFires);
  r.recoveries = (int)sh(kRecoveries);
  r.tail = shf(kTail);
  r.sent = shf(kSent);
  r.seen = shf(kSeen);
  r.claimed_b = shf(kClaimedB);
  r.probe_dl = shf(kProbeDl);
  r.rto_dl = shf(kRtoDl);
  r.done_ts = shf(kDoneTs);
  r.in_rec = in_rec;
  r.sacked = ledger_words(sk, lane);
  r.claimed = ledger_words(ck, lane);

  // ---- 1. the due SACK (flow_on_sack; no-op where invalid) ----
  const uint32_t lo = __ballot_sync(FULL_MASK, b_lo);
  const uint32_t hi = __ballot_sync(FULL_MASK, b_hi);
  if (valid) {
    Due d{true, ecn, probe_reply, (int)sh(kDueEpsn), (int)sh(kDueBase),
          (int)sh(kDueOoo), (int)sh(kDueEnt), shf(kDueRecvd), shf(kDueTs)};
    on_sack(cc, sp, r, d, ((uint64_t)hi << 32) | lo, p, lane);
  }

  // ---- 2. timer sweep on timer ticks (committed for released flows) ----
  bool pvalid = false, blocked = false;
  s.p_entropy = 0;
  s.p_psn = 0;
  if (p.timer_tick) {
    Rel rt = r;
    bool active = rt.epsn < rt.total;
    bool rto = active && (p.now >= rt.rto_dl);
    enter_recovery(rt, rt.psn_next, rto, p, lane);
    if (rto) rt.rto_dl = p.rto_at;
    rt.rto_fires += (int)rto;
    bool probe = active && !rto && (p.now >= rt.probe_dl);
    if (probe) rt.probe_dl = p.probe_at;
    Spray st = sp;
    s.p_entropy = choose_path(st, cc.cwnd, p, lane);
    s.p_psn = rt.epsn;
    pvalid = probe && (r.sent > 0.0f);  // probes only once data was sent
    // a paused NIC delays the probe: its timer state is not committed
    blocked = pvalid && s.paused;
    if (send_ok && !blocked) {
      r = rt;
      if (probe) sp = st;
    }
  }
  s.pvalid = pvalid;
  s.probe_valid = pvalid && send_ok && !blocked;

  // ---- 3. next-packet offer (rel_next_psn + choose_path) ----
  bool has_rtx = any_bits(r.claimed);
  float inflight = (r.sent - r.seen) - r.claimed_b;
  bool window_ok = inflight < cc.cwnd * p.mtu;
  bool seq_ok = (r.psn_next - r.epsn) < W;
  bool has_new = (r.psn_next < r.total) && seq_ok;
  s.valid = (r.epsn < r.total) && window_ok && (has_rtx || has_new);
  s.rtx_rel = first_set(r.claimed);
  s.use_rtx = s.valid && has_rtx;
  s.psn = s.use_rtx ? r.epsn + s.rtx_rel : r.psn_next;
  s.sn = sp;
  s.entropy = choose_path(s.sn, cc.cwnd, p, lane);
  s.can_tx = s.valid && send_ok;
  s.score = s.can_tx ? floor_mod(f % p.FE - p.t, p.NR) : p.NR;
}

// The fields the send leaves as they are, and the lane's outputs but sel:
// staged in the warp's shared row by lane 0, then stored a lane a slot
// (the next use of the row is behind the warp's next shuffle).
__device__ __forceinline__ void write_pre(const Step& s, const Slots& tb,
                                          const FlowPtrs& out, uint32_t* row,
                                          int f, int l, int lane) {
  const CC& cc = s.cc;
  const Rel& r = s.r;
  if (lane == 0) {
    row[pCwnd] = u(cc.cwnd);
    row[pBaseRtt] = u(cc.base_rtt);
    row[pAvgDelay] = u(cc.avg_delay);
    row[pLastDec] = u(cc.last_dec);
    row[pLastAi] = u(cc.last_ai);
    row[pAchieved] = u(cc.achieved);
    row[pRx] = u(cc.rx);
    row[pClearTs] = u(cc.clear_ts);
    row[pEpsn] = u(r.epsn);
    row[pTotal] = u(r.total);
    row[pTail] = u(r.tail);
    row[pSeen] = u(r.seen);
    row[pClaimedB] = u(r.claimed_b);
    row[pRecoverHigh] = u(r.recover_high);
    row[pProbeDl] = u(r.probe_dl);
    row[pRtoDl] = u(r.rto_dl);
    row[pDoneTs] = u(r.done_ts);
    row[pRtoFires] = u(r.rto_fires);
    row[pRecoveries] = u(r.recoveries);
    row[pInRec] = u(r.in_rec);
    row[pTxValid] = u(s.valid);
    row[pTxRtx] = u(s.use_rtx);
    row[pTxProbe] = 0u;
    row[pPValid] = u(s.pvalid);
    row[pPRtx] = 0u;
    row[pPProbe] = u(s.pvalid);
    row[pProbeValid] = u(s.probe_valid);
    row[pCanTx] = u(s.can_tx);
    row[pDoneLane] = u(r.epsn >= r.total);
    row[pTxPsn] = u(s.psn);
    row[pTxEnt] = u(s.entropy);
    row[pPPsn] = u(s.p_psn);
    row[pPEnt] = u(s.p_entropy);
  }
  __syncwarp();
  for (int k = lane; k < kPre; k += 32) {
    void* base = tb.pre[k];
    if (base == nullptr) continue;  // done_lane on the dense program
    if (k <= pRecoveries)
      static_cast<uint32_t*>(base)[f] = row[k];
    else if (k == pInRec)
      static_cast<uint8_t*>(base)[f] = (uint8_t)row[k];
    else if (k <= pDoneLane)
      static_cast<uint8_t*>(base)[l] = (uint8_t)row[k];
    else
      static_cast<uint32_t*>(base)[l] = row[k];
  }
  store_ledger(out.sacked + (size_t)f * W, r.sacked, lane);
}

// The send's fields, committed where sel: the sequence, the bytes sent,
// the retransmitted packet's claimed bit, the spray state after the path
// choice; and sel.
__device__ __forceinline__ void write_post(const Step& s, bool sel,
                                           const TransParams& p,
                                           const Slots& tb,
                                           const FlowPtrs& out, int f, int l,
                                           int lane) {
  const Rel& r = s.r;
  const uint32_t claimed =
      sel && s.use_rtx ? clear_bit(r.claimed, s.rtx_rel, lane) : r.claimed;
  store_ledger(out.claimed + (size_t)f * W, claimed, lane);
  // the committed spray state: after the send's path choice where sel
  const Spray sp{sel ? s.sn.bm : s.sp.bm, sel ? s.sn.rr : s.sp.rr,
                 sel ? s.sn.next_pid : s.sp.next_pid,
                 sel ? s.sn.last_reset : s.sp.last_reset};
  store_set<PW>(out.bitmap + (size_t)f * p.P, p.P, sp.bm, lane);
  // a lane a slot, each lane's value picked from the warp-uniform ones
  const float wire = (s.psn >= r.total - 1) ? r.tail : p.mtu;
  const uint32_t v[kPost] = {
      u(sel && s.valid && !s.use_rtx ? r.psn_next + 1 : r.psn_next),
      u(sel ? r.sent + (s.valid ? wire : 0.0f) : r.sent), u(sp.rr),
      u(sp.next_pid), u(sp.last_reset), u(sel)};
  uint32_t mine = v[0];
#pragma unroll
  for (int k = 1; k < kPost; ++k) mine = lane == k ? v[k] : mine;
  if (lane == qSel)
    static_cast<uint8_t*>(tb.post[lane])[l] = (uint8_t)mine;
  else if (lane < kPost)
    static_cast<uint32_t*>(tb.post[lane])[f] = mine;
}

__device__ __forceinline__ void write_inert(const TransOut& o, int l) {
  o.tx.valid[l] = false;
  o.tx.psn[l] = 0;
  o.tx.entropy[l] = 0;
  o.tx.is_rtx[l] = false;
  o.tx.is_probe[l] = false;
  o.probe.valid[l] = false;
  o.probe.psn[l] = 0;
  o.probe.entropy[l] = 0;
  o.probe.is_rtx[l] = false;
  o.probe.is_probe[l] = false;
  o.probe_valid[l] = false;
  o.sel[l] = false;
  o.can_tx[l] = false;
  o.done_lane[l] = false;
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

// Every argument of a launch, passed as one block of kernel parameters;
// a block copies it to shared memory once (one 8-byte word a thread), so
// that no thread waits on a constant-cache miss of a parameter.
struct Args {
  TransParams p;
  FlowPtrs in;
  SackPtrs due;
  const bool* sendable;  // [N] on the dense program, else null
  const bool* eff_nic;   // [NH] under PFC, else null
  const bool* live;      // [N / FE] a batch's stepping entries, or null
  const int* act;        // [L] the slate, or null
  const int *by_src, *src_sorted, *blocks;  // the source index
  FlowPtrs out;
  TransOut o;
  Slots sl;
};
static_assert(sizeof(Args) % 8 == 0, "copied in 8-byte words");

__global__ void __launch_bounds__(kThreads, 2)
    strack_kernel(const __grid_constant__ Args args) {
  extern __shared__ int s_slate[];  // [L] under the active set
  __shared__ Args sa;
  __shared__ uint32_t s_row[kWarps][kRow];
  __shared__ int s_min[kWarps];
  __shared__ int s_f[kWarps], s_l[kWarps], s_h[kWarps], s_slot[kWarps];
  __shared__ int s_n;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  for (int i = tid; i < (int)(sizeof(Args) / 8); i += kThreads)
    reinterpret_cast<uint64_t*>(&sa)[i] =
        reinterpret_cast<const uint64_t*>(&args)[i];
  __syncthreads();
  const TransParams& p = sa.p;
  const FlowPtrs &in = sa.in, &out = sa.out;
  const SackPtrs& due = sa.due;
  const TransOut& o = sa.o;
  const Slots& tb = sa.sl;
  const int* act = sa.act;

  // the slate's padded lanes, strided over the grid: inert
  if (act != nullptr)
    for (int l = blockIdx.x * kThreads + tid; l < p.L;
         l += gridDim.x * kThreads)
      if (act[l] >= p.N) write_inert(o, l);
  if ((int)blockIdx.x >= p.NB) return;
  const int p0 = sa.blocks[blockIdx.x], n = sa.blocks[blockIdx.x + 1] - p0;
  if (tid < kWarps) s_min[tid] = p.NR;
  const int* slate = nullptr;
  if (act != nullptr) {
    if (p.L <= kSlateSmem) {
      for (int i = tid; i < p.L; i += kThreads) s_slate[i] = act[i];
      slate = s_slate;
    } else {
      slate = act;
    }
  }
  __syncthreads();
  uint32_t* row = s_row[w];

  // the block's items: its flows, each with its lane and its source's
  // slot in s_min (sources come in order: the slot is the source's first
  // position in the block).  Up to kWarps flows: the live ones go to the
  // first warps, one round, and each warp holds its flow's step across
  // the barrier.  A source of more flows: the warps walk it twice, the
  // first pass for its minimum (slot 0), the second recomputing each flow
  // to commit it.
  const bool loop = n > kWarps;
  if (!loop && w == 0) {
    int f = 0, l = -1, h = -1;
    if (lane < n) {
      f = sa.by_src[p0 + lane];
      h = sa.src_sorted[p0 + lane];
      l = lane_of(slate, p.L, f);
    }
    int h_prev = __shfl_up_sync(FULL_MASK, h, 1);
    uint32_t starts =
        __ballot_sync(FULL_MASK, lane < n && (lane == 0 || h != h_prev));
    uint32_t live = __ballot_sync(FULL_MASK, l >= 0);
    if (l >= 0) {
      int k = __popc(live & ((1u << lane) - 1u));
      s_f[k] = f;
      s_l[k] = l;
      s_h[k] = h;
      s_slot[k] = 31 - __clz(starts & (FULL_MASK >> (31 - lane)));
    }
    if (lane == 0) s_n = __popc(live);
  }
  __syncthreads();
  const int per_pass = loop ? (n + kWarps - 1) / kWarps : 1;
  const int rounds = loop ? 2 * per_pass : 1;
  for (int r = 0; r < rounds; ++r) {  // block-uniform
    const int pass = loop ? r / per_pass : 1;  // 0: the minimum only
    int f = 0, l = -1, h = 0, slot = 0;
    if (loop) {
      const int i = (r % per_pass) * kWarps + w;
      if (i < n) {
        f = sa.by_src[p0 + i];
        h = sa.src_sorted[p0 + i];
        l = lane_of(slate, p.L, f);
      }
    } else if (w < s_n) {
      f = s_f[w];
      l = s_l[w];
      h = s_h[w];
      slot = s_slot[w];
    }
    Step s;
    if (l >= 0) {  // warp-uniform
      step_flow(s, p, tb, in, due, sa.sendable, sa.eff_nic, sa.live, f, h,
                lane);
      if (pass == 0 || !loop) {
        if (lane == 0) atomicMin(&s_min[slot], s.score);
      }
      if (pass == 1) write_pre(s, tb, out, row, f, l, lane);
    }
    if (!loop || r == per_pass - 1) __syncthreads();
    if (l >= 0 && pass == 1)
      write_post(s, s.can_tx && s.score == s_min[slot] && !s.paused, p, tb,
                 out, f, l, lane);
  }
}

}  // namespace

// sendable: [N] on the dense program (act null, L = N); null under the
// active set, whose lanes are released by construction (act: [L]).
// by_src [N], src_sorted [N] and blocks [NB + 1]: the program's source
// index.  A batch of B entries is one record of N = B FE flows (entry e's
// flow f at e FE + f, its hosts numbered e NH + h in the index) and live
// [B] (null: every entry steps).
extern "C" int strack_transition(const TransParams* p, const FlowPtrs* in,
                                 const SackPtrs* due, const bool* sendable,
                                 const bool* eff_nic, const bool* live,
                                 const int* act, const int* by_src,
                                 const int* src_sorted, const int* blocks,
                                 const FlowPtrs* out,
                                 const TransOut* o, cudaStream_t stream) {
  if (p->P > MAXP || p->B > 64 || p->NR <= 0 || p->FE <= 0 ||
      p->N % p->FE != 0)
    return (int)cudaErrorInvalidValue;
  if ((act == nullptr) != (sendable != nullptr) ||
      (act == nullptr && p->L != p->N) ||
      (act != nullptr && o->done_lane == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p->L <= 0) return 0;
  size_t smem = act != nullptr && p->L <= kSlateSmem ? sizeof(int) * p->L : 0;
  int grid = p->NB > 0 ? p->NB : 1;
  Args a{*p,   *in,    *due,       sendable, eff_nic, live,
         act,  by_src, src_sorted, blocks,   *out,    *o, {}};
  for (int k = 0; k < kLoads; ++k)
    a.sl.ld[k] = static_cast<const uint32_t*>(load_ptr(*in, *due, k));
  for (int k = 0; k < kPre; ++k) a.sl.pre[k] = pre_ptr(*out, *o, k);
  for (int k = 0; k < kPost; ++k) a.sl.post[k] = post_ptr(*out, *o, k);
  strack_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
