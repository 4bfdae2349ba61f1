"""The fabric hot path's kernels: CUDA on the card, plain PyTorch on the
CPU.

Each kernel of the reference (``repro/kernels/fabric_kernels.py``, all
Pallas) has here a wrapper, a plain PyTorch version of the same function
and a hand-written CUDA kernel under ``csrc/``:

===============================  =====================================  ==========================
wrapper                          reference kernel (Pallas)              CUDA source
===============================  =====================================  ==========================
:func:`flow_transition`          ``flow_transition_kernel`` over        ``csrc/transition.cu``
                                 ``fabric.dense_trans_core`` (STrack)   (STrack),
                                 and over RoCEv2's DCQCN record         ``csrc/transition_roce.cu``
:func:`flow_transition_active`   the same over                          the same two sources, with
                                 ``fabric.active_trans_core``           the slate ``act_idx``
:func:`serve_enqueue`            ``serve_enqueue_kernel`` over          ``csrc/serve_enqueue.cu``
                                 ``fabric.serve_enqueue_core``
:func:`rank_in_queue`            ``rank_in_queue_kernel`` /             ``csrc/rank.cu``
                                 ``rank_in_queue_core``
:func:`pfc_account`              none: the tick's inline PFC stage      ``csrc/serve_enqueue.cu``
                                 (``fabric.py`` stage 6b)
===============================  =====================================  ==========================

On the card every wrapper of the tick is one launch: the transitions
arbitrate each NIC inside one block, over the program's
:class:`SrcIndex` (the flows grouped by source); the ranker's work runs
inside serve/enqueue's kernel, so the fabric's tick no longer launches
``csrc/rank.cu``, which stays the counterpart of
``rank_in_queue_kernel``.

Under PFC the transition takes the NICs' effective pause mask and serve
the paused rows; :func:`pfc_account` then keeps the byte counters and the
pause gates.  Under a fault schedule serve takes the tick's down,
duty-cycle and corruption rows and the corruption draw's seed.

Under the active set (``FabricConfig.active_cap = A``) the transport
lanes are the slate ``act_idx`` (i32[A]: the released, unfinished flows in
ascending order, padded with N): :func:`flow_transition_active` steps
those rows of the [N] flow record in place, serve reads each injection
lane's flow through ``lane_flow``, and :func:`pfc_account` sums each
host's injections over the lanes of ``lanes``.  A padded lane is inert.

A batch of B entries of one program shape (``sim.fabric.BatchProgram``)
calls :func:`flow_transition_batch`, :func:`serve_enqueue_batch` and
:func:`pfc_account_batch`: every input with a leading axis B, one launch
of the same kernels for the whole batch (the transitions' block table
spans the entries, :func:`src_index_batch`; serve and the PFC stage loop
over B entries' rows), and a ``live`` mask of the entries that step: a
frozen entry's rows come out as they went in.

Dispatch is by the device of the tensors: a wrapper runs the plain version
for CPU tensors and launches its kernel for CUDA tensors, or raises; there
is no fallback and no switch.  Every launch adds one to
``launches[name]``.  The sources are built and bound by :mod:`._build`;
they run on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.params import ACK_WIRE_BYTES
from ..core.transport import TxPacket, tree_where
from ..numerics import Now, ecn_dither, f32, recip32
from ..sim.faults import fault_u01
from ._build import check as _check, launch as _launch, load, \
    ptr as _ptr, route as _route, stream as _stream

#: Launches of each wrapper's kernel since the last :func:`reset_launches`.
launches = {"flow_transition": 0, "flow_transition_roce": 0,
            "flow_transition_active": 0, "flow_transition_roce_active": 0,
            "serve_enqueue": 0, "rank_in_queue": 0, "pfc_account": 0,
            "flow_transition_batch": 0, "flow_transition_roce_batch": 0,
            "serve_enqueue_batch": 0, "pfc_account_batch": 0}

#: Block width of the chunked ranker.
RANK_CHUNK = 256


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class PktQ(NamedTuple):
    """Ring-buffer packet fields, shape [n_queues + 1, cap] (last row
    trash; its contents are never read)."""

    flow: torch.Tensor   # i32
    psn: torch.Tensor    # i32
    ts: torch.Tensor     # f32 (send timestamp, us)
    probe: torch.Tensor  # bool
    ecn: torch.Tensor    # bool (accumulated across hops)
    ent: torch.Tensor    # i32 (path entropy)
    ready: torch.Tensor  # i32 (departure-time lane: earliest service tick)
    spine: torch.Tensor  # i32 (spine chosen at injection; 0 for same-ToR)


class TransDims(NamedTuple):
    """Static inputs of the transition stage: the protocol's parameters
    (``STrackParams`` or ``dcqcn_fab.RoceFabParams``), and the fabric's
    protocol record (``sim.fabric.Protocol``) whose batched ``on_ack`` /
    ``on_timer`` (with the probe gate) / ``next_packet`` the plain version
    runs."""

    p: object
    proto: object
    tick_us: float
    timer_every: int
    n_hosts: int      # NH: NIC arbitration segments
    n_real: int       # NR: round-robin modulus


class ServeDims(NamedTuple):
    """Static inputs of the serve/enqueue stage; under PFC the drop
    thresholds are the lossless ones."""

    n_tor: int
    n_spine: int
    n_hosts: int
    n_flows: int
    cap: int
    K: int                 # per-link propagation, ticks
    data_drop_pkts: int
    hard_pkts: int
    kmin_p: float
    kmax_p: float
    mtu_bytes: int
    tick_us: float


# --------------------------------------------------------------------------- #
# Kernel 3 of the reference: the stable per-queue ranker
# --------------------------------------------------------------------------- #

def rank_in_queue_plain(qid: torch.Tensor, flag: torch.Tensor,
                        n_queues: int) -> torch.Tensor:
    """Rank of each flagged candidate among flagged candidates of the same
    queue, in candidate-index order; ``-1`` where unflagged.  Chunked: a
    per-(block, queue) count table, an exclusive cumsum down the block
    axis, and a strictly-lower-triangle count inside each block."""
    m = qid.shape[0]
    dev = qid.device
    if m == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    c = RANK_CHUNK
    pad = (-m) % c
    qid_p = torch.cat([qid.to(torch.int32),
                       torch.full((pad,), n_queues, dtype=torch.int32,
                                  device=dev)])
    flag_p = torch.cat([flag, torch.zeros((pad,), dtype=torch.bool,
                                          device=dev)])
    nb = qid_p.shape[0] // c
    qw = n_queues + 1
    blk = torch.arange(nb, dtype=torch.int64, device=dev).repeat_interleave(c)
    slot = blk * qw + torch.where(flag_p, qid_p, n_queues).long()
    tbl = torch.zeros(nb * qw, dtype=torch.int32, device=dev)
    tbl.index_add_(0, slot, flag_p.to(torch.int32))
    tbl = tbl.view(nb, qw)
    start = torch.cumsum(tbl, 0, dtype=torch.int32) - tbl
    base = start.view(-1)[blk * qw + qid_p.long()]
    qc, fc = qid_p.view(nb, c), flag_p.view(nb, c)
    tril = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)
    intra = ((qc[:, :, None] == qc[:, None, :]) & fc[:, None, :]
             & tril[None]).sum(2, dtype=torch.int32)
    ranks = base + intra.view(-1)
    return torch.where(flag, ranks[:m], -1).to(torch.int32)


def rank_in_queue(qid: torch.Tensor, flag: torch.Tensor,
                  n_queues: int) -> torch.Tensor:
    """The ranker: plain version on CPU tensors, ``csrc/rank.cu`` on CUDA
    tensors (three launches: per-block counts, block-axis scan, resolve)."""
    m = qid.shape[0]
    _check("qid", qid, torch.int32, (m,))
    _check("flag", flag, torch.bool, (m,), qid.device)
    if _route(qid) == "plain":
        return rank_in_queue_plain(qid, flag, n_queues)
    if qid.numel() and int(n_queues) < 1:
        raise ValueError("n_queues must be positive")
    out = torch.empty((m,), dtype=torch.int32, device=qid.device)
    if m == 0:
        return out
    nb = -(-m // RANK_CHUNK)
    tbl = torch.empty((nb * (n_queues + 1),), dtype=torch.int32,
                      device=qid.device)
    _launch(_lib("rank").rank_in_queue, _ptr(qid), _ptr(flag), _ptr(out),
            _ptr(tbl), ctypes.c_int(m), ctypes.c_int(int(n_queues)),
            _stream(qid))
    launches["rank_in_queue"] += 1
    return out


# --------------------------------------------------------------------------- #
# The flows grouped by source NIC, built once a run
# --------------------------------------------------------------------------- #

#: Flows a block of the transition kernels takes: whole sources, at most
#: this many flows, or one source with more (``kWarps`` of
#: ``csrc/transition.cu``).
BLOCK_FLOWS = 16


class SrcIndex(NamedTuple):
    """The flows grouped by source NIC (a CSR of ``src``), built once a run
    by :func:`src_index`: the transitions arbitrate each NIC inside one
    block of ``blocks``, the PFC stage sums a host's injections in flow
    order."""

    by_src: torch.Tensor      # i32[N]: flows sorted by src, stable
    src_start: torch.Tensor   # i32[NH + 1]: offsets of each host in by_src
    blocks: torch.Tensor      # i32[B + 1]: offsets in by_src of the blocks
    src_sorted: torch.Tensor  # i32[N]: src[by_src], the sources in order


def _blocks(counts: list, cap: int) -> list:
    """Offsets of consecutive runs of whole sources of at most ``cap``
    flows each (a source with more: a run of its own), given each source's
    flow count."""
    out, pos, fill = [0], 0, 0
    for c in counts:
        if c and fill and fill + c > cap:
            out.append(pos)
            fill = 0
        pos += c
        fill += c
        if fill > cap:
            out.append(pos)
            fill = 0
    if fill:
        out.append(pos)
    return out


def src_index(src: torch.Tensor, n_hosts: int) -> SrcIndex:
    """The :class:`SrcIndex` of ``src`` (i32[N], hosts in ``[0,
    n_hosts)``), on ``src``'s device; made on the host (one read of
    ``src``)."""
    s = src.cpu().long()
    src_sorted, by_src = torch.sort(s, stable=True)
    counts = torch.bincount(s, minlength=n_hosts)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    blocks = torch.tensor(_blocks(counts.tolist(), BLOCK_FLOWS))
    return SrcIndex(*[x.to(device=src.device, dtype=torch.int32)
                      for x in (by_src, start, blocks, src_sorted)])


def src_index_batch(src: torch.Tensor, n_hosts: int) -> SrcIndex:
    """The :class:`SrcIndex` of a batch ``src`` (i32[B, N]): entry b's
    flows and hosts numbered ``b N + f`` and ``b n_hosts + h``, so one
    block table spans the entries (a block may end one entry's sources
    and begin the next's; a source never spans two blocks)."""
    b, n = src.shape
    off = torch.arange(b, dtype=torch.int32, device=src.device)[:, None]
    return src_index((src + off * n_hosts).reshape(-1), b * n_hosts)


# --------------------------------------------------------------------------- #
# Kernel 1 of the reference: per-flow transport transitions
# --------------------------------------------------------------------------- #

def _empty_tx(n: int, device) -> TxPacket:
    z = lambda dt: torch.zeros((n,), dtype=dt, device=device)
    return TxPacket(valid=z(torch.bool), psn=z(torch.int32),
                    entropy=z(torch.int32), is_rtx=z(torch.bool),
                    is_probe=z(torch.bool))


def flow_transition_plain(flows, due, sendable: torch.Tensor,
                          src: torch.Tensor, t: int, d: TransDims,
                          eff_nic=None, index=None, lane_id=None):
    """``dense_trans_core``: apply the due message, run the timer sweep on
    timer ticks (a probe only once the flow has sent data), offer the next
    packet, and arbitrate each NIC round-robin (the lowest ``(lane - t) %
    NR`` of the flows that can send wins).  Under PFC (``eff_nic``, the
    NICs' effective pause mask) a probe of a paused NIC is withheld with
    its timer state, and a paused NIC's winner commits nothing.
    ``index`` (the program's :class:`SrcIndex`, which the kernels need)
    is not read: each NIC's minimum is a ``scatter_reduce``.  ``lane_id``
    (i32[n]) is each lane's flow index for the round robin, the lane
    itself by default.

    Returns ``(flows, tx, probe_tx, probe_valid, sel, can_tx)``."""
    proto = d.proto
    n = sendable.shape[0]
    dev = sendable.device
    now = Now(t, d.tick_us)
    fl = proto.on_ack(flows, due, now)
    if t % d.timer_every == 0:
        fl_t, probe_tx = proto.on_timer(fl, now)
    else:
        fl_t, probe_tx = fl, _empty_tx(n, dev)
    paused = (torch.zeros_like(sendable) if eff_nic is None
              else eff_nic[src.long()])
    blocked = probe_tx.valid & paused
    probe_valid = probe_tx.valid & sendable & (~blocked)
    fl = tree_where(sendable & (~blocked), fl_t, fl)
    fl_sent, tx = proto.next_packet(fl, now)
    can_tx = tx.valid & sendable
    if lane_id is None:
        lane_id = torch.arange(n, dtype=torch.int32, device=dev)
    score = torch.where(can_tx, (lane_id - t) % d.n_real, d.n_real
                        ).to(torch.int32)
    best = torch.full((d.n_hosts,), torch.iinfo(torch.int32).max,
                      dtype=torch.int32, device=dev)
    best = best.scatter_reduce(0, src.long(), score, "amin")
    sel = can_tx & (score == best[src.long()]) & (~paused)
    fl = tree_where(sel, fl_sent, fl)
    return fl, tx, probe_tx, probe_valid, sel, can_tx


def _check_index(index, n: int, dev) -> None:
    if index is None:
        raise ValueError("index: the transition kernels take the program's "
                         "SrcIndex (src_index)")
    _check("index.by_src", index.by_src, torch.int32, (n,), dev)
    _check("index.src_sorted", index.src_sorted, torch.int32, (n,), dev)
    _check("index.blocks", index.blocks, torch.int32,
           (index.blocks.shape[0],), dev)
    if index.blocks.shape[0] < 1:
        raise ValueError("index.blocks: expected at least one offset")


def flow_transition(flows, due, sendable: torch.Tensor, src: torch.Tensor,
                    t: int, d: TransDims, eff_nic=None, index=None):
    """The transition stage: plain version on CPU tensors; on CUDA tensors
    one launch of ``csrc/transition.cu`` (STrack) or
    ``csrc/transition_roce.cu`` (RoCEv2): a block takes the whole sources
    of one block of ``index`` (the program's :class:`SrcIndex`), steps
    their flows, finds each NIC's minimum score in shared memory and
    commits the winners' sends.  ``eff_nic`` (bool[NH]) is the PFC gate,
    ``None`` on lossy queues."""
    n = sendable.shape[0]
    _check("sendable", sendable, torch.bool, (n,))
    _check("src", src, torch.int32, (n,), sendable.device)
    if eff_nic is not None:
        _check("eff_nic", eff_nic, torch.bool, (d.n_hosts,), sendable.device)
    if _route(sendable) == "plain":
        return flow_transition_plain(flows, due, sendable, src, t, d,
                                     eff_nic, index)
    _check_index(index, n, sendable.device)
    from . import _cuda_bind
    if d.proto.name == "rocev2":
        out = _cuda_bind.transition_roce(_lib("transition_roce"), flows, due,
                                         sendable, src, t, d, eff_nic, index)
        launches["flow_transition_roce"] += 1
    else:
        out = _cuda_bind.transition(_lib("transition"), flows, due, sendable,
                                    src, t, d, eff_nic, index)
        launches["flow_transition"] += 1
    return out


def _tree_leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


# --------------------------------------------------------------------------- #
# The batch: B entries of one program shape along a leading axis
# --------------------------------------------------------------------------- #

def _rebuild(like: tuple, items: list) -> tuple:
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of (named) tuples; ``None`` stays."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return _rebuild(tree, [tree_map(fn, v) for v in tree])
    return fn(tree)


def _stack(trees: list):
    """Entries' trees stacked along a new leading axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return _rebuild(first, [_stack([t[i] for t in trees])
                                for i in range(len(first))])
    return torch.stack(trees)


def _entry(tree, b: int):
    return tree_map(lambda x: x[b], tree)


def flat_entries(tree):
    """A batch's leaves [B, n, ...] as [B n, ...] (views)."""
    return tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), tree)


def _check_batch(name, t, dtype, shape, dev) -> None:
    if t is not None:
        _check(name, t, dtype, shape, dev)


def flow_transition_batch_plain(flows, due, sendable, src, t: int,
                                d: TransDims, eff_nic=None, index=None,
                                live=None):
    """:func:`flow_transition_plain` on each entry of a batch (every input
    with a leading axis B; ``index`` is not read).  A frozen entry
    (``live[b]`` False; ``live`` None: every entry steps) applies no due
    message and is not sendable, so its flow rows come out as they went
    in and it offers and commits nothing."""
    outs = []
    for b in range(sendable.shape[0]):
        ok, due_b = sendable[b], _entry(due, b)
        if live is not None:
            ok = ok & live[b]
            due_b = due_b._replace(valid=due_b.valid & live[b])
        outs.append(flow_transition_plain(
            _entry(flows, b), due_b, ok, src[b], t, d,
            None if eff_nic is None else eff_nic[b]))
    return _stack(outs)


def flow_transition_batch(flows, due, sendable: torch.Tensor,
                          src: torch.Tensor, t: int, d: TransDims,
                          eff_nic=None, index=None, live=None):
    """The transition stage on a batch of B entries at one tick ``t``:
    the plain version on CPU tensors; on CUDA tensors one launch of
    ``csrc/transition.cu`` (STrack) or ``csrc/transition_roce.cu``
    (RoCEv2) for the whole batch, its blocks taken from ``index``
    (:func:`src_index_batch`), whose table spans the entries.  Every
    input has a leading axis B (``sendable``, ``src`` [B, N], ``eff_nic``
    [B, NH]); ``live`` (bool[B] or None) marks the entries that step."""
    bsz, n = sendable.shape
    dev = sendable.device
    _check("sendable", sendable, torch.bool, (bsz, n))
    _check("src", src, torch.int32, (bsz, n), dev)
    _check_batch("eff_nic", eff_nic, torch.bool, (bsz, d.n_hosts), dev)
    _check_batch("live", live, torch.bool, (bsz,), dev)
    if _route(sendable) == "plain":
        return flow_transition_batch_plain(flows, due, sendable, src, t, d,
                                           eff_nic, index, live)
    _check_index(index, bsz * n, dev)
    from . import _cuda_bind
    args = (flat_entries(flows), flat_entries(due), sendable.reshape(-1),
            src.reshape(-1), t, d,
            None if eff_nic is None else eff_nic.reshape(-1), index)
    if d.proto.name == "rocev2":
        out = _cuda_bind.transition_roce(_lib("transition_roce"), *args,
                                         entry=(n, live))
        launches["flow_transition_roce_batch"] += 1
    else:
        out = _cuda_bind.transition(_lib("transition"), *args,
                                    entry=(n, live))
        launches["flow_transition_batch"] += 1
    return tree_map(lambda x: x.view((bsz, n) + tuple(x.shape[1:])), out)


def _gather_rows(tree, idx: torch.Tensor, n: int):
    """Rows ``idx`` of a per-flow state tuple; ``idx == n`` reads a zero
    trash row."""
    if isinstance(tree, tuple):
        return type(tree)(*[_gather_rows(v, idx, n) for v in tree])
    pad = tree.new_zeros((1,) + tuple(tree.shape[1:]))
    return torch.cat([tree, pad])[idx]


def _scatter_rows_(tree, rows, idx: torch.Tensor, n: int) -> None:
    """Write ``rows`` back into rows ``idx`` of a per-flow state tuple, IN
    PLACE; ``idx == n`` hits a trash row that is dropped."""
    for a, b in zip(_tree_leaves(tree), _tree_leaves(rows)):
        buf = torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))])
        buf[idx] = b
        a.copy_(buf[:n])


def flow_transition_active_plain(flows, due, act_idx: torch.Tensor,
                                 src: torch.Tensor, t: int, d: TransDims,
                                 eff_nic=None, index=None):
    """``active_trans_core``: the transition on the lanes of the slate
    ``act_idx`` (i32[A], released unfinished flows in ascending order,
    padded with N).  Gathers the lanes' flow rows and due rows (``due`` is
    the [N] return-pipe slot of this tick), runs :func:`flow_transition_plain`
    on them with the flows' own indices as round-robin ids and the lanes'
    sources as NIC segments, and scatters the rows back into the [N] flow
    record IN PLACE; flows outside the slate keep their rows.  ``index``
    is not read.  A padded
    lane is inert: it writes no row, offers nothing and its ``tx`` and
    ``probe_tx`` rows are zeros.

    Returns ``(flows, tx, probe_tx, probe_valid, sel, can_tx, done_lane)``
    with per-lane outputs of length A; ``done_lane`` is each lane's flow
    done after the step (False on a padded lane)."""
    n = src.shape[0]
    ok = act_idx < n
    idx = act_idx.long()
    rows = _gather_rows(flows, idx, n)
    due_l = _gather_rows(due, idx, n)
    lane_src = src[idx.clamp(max=n - 1)]
    fl, tx, ptx, pv, sel, can = flow_transition_plain(
        rows, due_l, ok, lane_src, t, d, eff_nic, lane_id=act_idx)
    _scatter_rows_(flows, fl, idx, n)
    zero = _empty_tx(act_idx.shape[0], act_idx.device)
    return (flows, tree_where(ok, tx, zero), tree_where(ok, ptx, zero), pv,
            sel, can, d.proto.done(fl) & ok)


def flow_transition_active(flows, due, act_idx: torch.Tensor,
                           src: torch.Tensor, t: int, d: TransDims,
                           eff_nic=None, index=None):
    """The transition stage on the active set: plain version on CPU
    tensors; on CUDA tensors one launch of ``csrc/transition.cu`` (STrack)
    or ``csrc/transition_roce.cu`` (RoCEv2) with the slate: a block walks
    the flows of its sources in ``index``, keeps those of the slate (their
    lanes found by binary search) and arbitrates as the dense launch does.
    The flow record is updated in place either way."""
    n = src.shape[0]
    a = act_idx.shape[0]
    _check("act_idx", act_idx, torch.int32, (a,))
    _check("src", src, torch.int32, (n,), act_idx.device)
    if eff_nic is not None:
        _check("eff_nic", eff_nic, torch.bool, (d.n_hosts,), act_idx.device)
    if _route(act_idx) == "plain":
        return flow_transition_active_plain(flows, due, act_idx, src, t, d,
                                            eff_nic, index)
    _check_index(index, n, act_idx.device)
    from . import _cuda_bind
    if d.proto.name == "rocev2":
        out = _cuda_bind.transition_roce(_lib("transition_roce"), flows, due,
                                         None, src, t, d, eff_nic, index,
                                         act_idx)
        launches["flow_transition_roce_active"] += 1
    else:
        out = _cuda_bind.transition(_lib("transition"), flows, due, None,
                                    src, t, d, eff_nic, index, act_idx)
        launches["flow_transition_active"] += 1
    return out


# --------------------------------------------------------------------------- #
# Kernel 2 of the reference: ring service + two-pass enqueue
# --------------------------------------------------------------------------- #

def _wire(flow, psn, probe, total_pkts, tail_b, mtu):
    """Per-packet wire size: probes are ACK-sized, a message's final PSN
    is its odd tail, everything else a full MTU."""
    f = flow.clamp(0, total_pkts.shape[0] - 1).long()
    tail = psn >= total_pkts[f] - 1
    return torch.where(probe, f32(ACK_WIRE_BYTES),
                       torch.where(tail, tail_b[f], f32(mtu)))


def serve_enqueue_plain(q: PktQ, qhead, qsize, dst, dst_tor, total_pkts,
                        tail_b, tx_psn, probe_psn, ent_d, ent_p, spine,
                        spine_p, sel, probe_valid, inj_q, inj_qp, t: int,
                        d: ServeDims, paused_row=None, row_down=None,
                        row_duty=None, row_cor_p=None, fseed=None,
                        lane_flow=None):
    """``serve_enqueue_core``.

    Serve: each queue that is not paused (``paused_row``, bool[Q], the
    PFC gate; ``None`` on lossy queues) and whose duty cycle is open
    (``row_duty``, bool[Q], degraded links) pops its head once the head's
    departure-time lane says it has arrived, ECN-marking on the occupancy
    fraction against the sin dither.  A down row (``row_down``, bool[Q])
    blackholes what it pops; a data packet that survives is dropped when
    ``fault_u01(fseed, row, t, psn) < row_cor_p[row]`` (f32[Q], corrupting
    links).  Enqueue: the surviving fabric advances plus NIC data and
    probe injections rank among same-queue candidates, drop on occupancy,
    rank again among the accepted and land in the ring rows.  The four
    fault inputs are ``None`` without a fault schedule.  The injection
    inputs (``tx_psn`` ... ``inj_qp``) are per transport lane; lane ``l``
    sends for flow ``lane_flow[l]`` (i32[L]: the active set's clipped
    slate), which sets the candidate's flow and wire bytes; ``None`` means
    lane = flow (L = N).

    The ring ``q`` is updated IN PLACE; returns ``(qhead, qsize, pop, has,
    ecn_out, pop_bytes, cand_qid, accept, drops_add, cand_bytes, surv,
    bh_add, cor_add)``: ``cand_bytes`` the wire bytes of each candidate,
    ``surv`` the popped packets that go on (``has`` itself without
    faults), ``bh_add`` and ``cor_add`` the blackholed and corrupted
    counts (i32 scalars; ``None`` without faults)."""
    T, S, NH, N, cap = d.n_tor, d.n_spine, d.n_hosts, d.n_flows, d.cap
    TS = T * S
    Q = 2 * TS + NH
    dev = qhead.device
    now = Now(t, d.tick_us)
    qrows = torch.arange(Q, dtype=torch.int32, device=dev)
    is_up = qrows < TS
    spine_row = torch.where(is_up, qrows % S, (qrows - TS) // T)

    qs = qsize[:Q]
    hidx = (qhead[:Q] % cap).long()
    pop = PktQ(*[f[qrows.long(), hidx] for f in q])
    has = (qs > 0) & (pop.ready <= t)
    if paused_row is not None:
        has = has & (~paused_row)
    if row_duty is not None:
        has = has & row_duty
    residual = torch.clamp_min(qs - 1, 0).to(torch.float32)
    frac = torch.clamp((residual - f32(d.kmin_p))
                       * recip32(max(d.kmax_p - d.kmin_p, 1e-9)), 0.0, 1.0)
    dither = ecn_dither(t, qrows)
    mark = has & (~pop.probe) & (frac > dither * f32(0.999))
    ecn_out = pop.ecn | mark
    served = has.to(torch.int32)
    qhead1 = qhead.clone()
    qsize1 = qsize.clone()
    qhead1[:Q] += served
    qsize1[:Q] -= served

    surv, bh_add, cor_add = has, None, None
    if any(x is not None for x in (row_down, row_duty, row_cor_p)):
        bh_add = cor_add = torch.zeros((), dtype=torch.int32, device=dev)
    if row_down is not None:
        bh_add = (has & row_down).sum(dtype=torch.int32)
        surv = surv & (~row_down)
    if row_cor_p is not None:
        u = fault_u01(fseed, qrows, t, pop.psn)
        corrupt = surv & (~pop.probe) & (u < row_cor_p)
        cor_add = corrupt.sum(dtype=torch.int32)
        surv = surv & (~corrupt)

    fclip = pop.flow.clamp(0, N - 1).long()
    pop_bytes = _wire(pop.flow, pop.psn, pop.probe, total_pkts, tail_b,
                      d.mtu_bytes)
    adv_tgt = torch.where(is_up, TS + spine_row * T + dst_tor[fclip],
                          2 * TS + dst[fclip])[:2 * TS]
    L = sel.shape[0]
    lanes = (torch.arange(N, dtype=torch.int32, device=dev)
             if lane_flow is None else lane_flow)
    cand_qid = torch.cat([adv_tgt, inj_q, inj_qp]).to(torch.int32)
    cand_valid = torch.cat([surv[:2 * TS], sel, probe_valid])
    zb = torch.zeros((L,), dtype=torch.bool, device=dev)
    now_l = torch.full((L,), now, dtype=torch.float32, device=dev)
    M = 2 * TS + 2 * L
    cand = PktQ(
        flow=torch.cat([pop.flow[:2 * TS], lanes, lanes]),
        psn=torch.cat([pop.psn[:2 * TS], tx_psn, probe_psn]),
        ts=torch.cat([pop.ts[:2 * TS], now_l, now_l]),
        probe=torch.cat([pop.probe[:2 * TS], zb, ~zb]),
        ecn=torch.cat([ecn_out[:2 * TS], zb, zb]),
        ent=torch.cat([pop.ent[:2 * TS], ent_d, ent_p]),
        ready=torch.full((M,), t + 1 + d.K, dtype=torch.int32, device=dev),
        spine=torch.cat([pop.spine[:2 * TS], spine, spine_p]))
    cand_bytes = torch.cat([
        pop_bytes[:2 * TS],
        _wire(lanes, tx_psn, zb, total_pkts, tail_b, d.mtu_bytes),
        _wire(lanes, probe_psn, ~zb, total_pkts, tail_b, d.mtu_bytes)])

    # The reference counts all pairs up to 256 candidates and runs the
    # ranker above; both give the same rank wherever the flag is set, and
    # only flagged entries are read.
    rank_among = lambda flag: rank_in_queue_plain(cand_qid, flag, Q)
    qid_l = cand_qid.long()
    occ = qsize1[qid_l] + rank_among(cand_valid)
    dropped = cand_valid & (((~cand.probe) & (occ >= d.data_drop_pkts))
                            | (occ >= d.hard_pkts))
    accept = cand_valid & (~dropped)
    pos = (qhead1[qid_l] + qsize1[qid_l] + rank_among(accept)) % cap
    flat = torch.where(accept, qid_l * cap + pos, Q * cap)
    for f, v in zip(q, cand):
        f.view(-1)[flat] = v
    added = torch.zeros((Q + 1,), dtype=torch.int32, device=dev)
    added.index_add_(0, torch.where(accept, qid_l, Q),
                     accept.to(torch.int32))
    qsize2 = qsize1 + added
    qsize2[Q] = 0
    qhead1[Q] = 0
    drops_add = dropped.sum(dtype=torch.int32)
    return (qhead1, qsize2, pop, has, ecn_out, pop_bytes, cand_qid, accept,
            drops_add, cand_bytes, surv, bh_add, cor_add)


def serve_enqueue(q: PktQ, qhead, qsize, dst, dst_tor, total_pkts, tail_b,
                  tx_psn, probe_psn, ent_d, ent_p, spine, spine_p, sel,
                  probe_valid, inj_q, inj_qp, t: int, d: ServeDims,
                  paused_row=None, row_down=None, row_duty=None,
                  row_cor_p=None, fseed=None, lane_flow=None):
    """The serve/enqueue stage: plain version on CPU tensors,
    ``csrc/serve_enqueue.cu`` on CUDA tensors, one launch of a persistent
    kernel (serve + candidate build with the fault rows and the corruption
    draw; each queue's valid candidates counted into a bucket; one thread
    a queue walks its bucket in candidate order for the drop decision,
    the rank among the accepted and the ring placement, a warp where a
    bucket holds more than eight: the ranker's work without its
    launches).  The ring ``q`` is updated in place either way;
    ``paused_row`` is the PFC gate
    (``None`` on lossy queues), ``row_down``, ``row_duty``, ``row_cor_p``
    and ``fseed`` the tick's faults (``None`` without a schedule),
    ``lane_flow`` the lanes' flows under the active set (``None``: lane =
    flow)."""
    args = (q, qhead, qsize, dst, dst_tor, total_pkts, tail_b, tx_psn,
            probe_psn, ent_d, ent_p, spine, spine_p, sel, probe_valid,
            inj_q, inj_qp, t, d, paused_row, row_down, row_duty, row_cor_p,
            fseed, lane_flow)
    if _route(qhead) == "plain":
        return serve_enqueue_plain(*args)
    from . import _cuda_bind
    out = _cuda_bind.serve_enqueue(_lib("serve_enqueue"), *args)
    launches["serve_enqueue"] += 1
    return out


def serve_enqueue_batch_plain(q: PktQ, qhead, qsize, dst, dst_tor,
                              total_pkts, tail_b, tx_psn, probe_psn, ent_d,
                              ent_p, spine, spine_p, sel, probe_valid, inj_q,
                              inj_qp, t: int, d: ServeDims, paused_row=None,
                              row_down=None, row_duty=None, row_cor_p=None,
                              fseed=None, live=None):
    """:func:`serve_enqueue_plain` on each entry of a batch: every input
    but the fault rows (one schedule for the whole batch) with a leading
    axis B.  A frozen entry (``live[b]`` False) serves no row and
    enqueues no injection: its ring, heads and sizes stay as they are.
    The drop and fault counts come out per entry ([B])."""
    Q = 2 * d.n_tor * d.n_spine + d.n_hosts
    outs = []
    for b in range(qhead.shape[0]):
        pr = None if paused_row is None else paused_row[b]
        s, pv = sel[b], probe_valid[b]
        if live is not None:
            gone = ~live[b]
            pr = gone.expand(Q) if pr is None else pr | gone
            s, pv = s & live[b], pv & live[b]
        outs.append(serve_enqueue_plain(
            _entry(q, b), qhead[b], qsize[b], dst[b], dst_tor[b],
            total_pkts[b], tail_b[b], tx_psn[b], probe_psn[b], ent_d[b],
            ent_p[b], spine[b], spine_p[b], s, pv, inj_q[b], inj_qp[b], t, d,
            pr, row_down, row_duty, row_cor_p, fseed))
    return _stack(outs)


def serve_enqueue_batch(q: PktQ, qhead, qsize, dst, dst_tor, total_pkts,
                        tail_b, tx_psn, probe_psn, ent_d, ent_p, spine,
                        spine_p, sel, probe_valid, inj_q, inj_qp, t: int,
                        d: ServeDims, paused_row=None, row_down=None,
                        row_duty=None, row_cor_p=None, fseed=None,
                        live=None):
    """The serve/enqueue stage on a batch of B entries at one tick:
    plain version on CPU tensors; on CUDA tensors one launch of
    ``csrc/serve_enqueue.cu``'s persistent kernel whose grid-stride
    loops cover B x (Q + 1) rows and B x M candidates through the same
    two grid-wide barriers.  Inputs and outputs as
    :func:`serve_enqueue_batch_plain`'s; the ring ``q`` ([B, Q + 1, cap])
    is updated in place either way."""
    args = (q, qhead, qsize, dst, dst_tor, total_pkts, tail_b, tx_psn,
            probe_psn, ent_d, ent_p, spine, spine_p, sel, probe_valid,
            inj_q, inj_qp, t, d, paused_row, row_down, row_duty, row_cor_p,
            fseed)
    _check_batch("live", live, torch.bool, (qhead.shape[0],), qhead.device)
    if _route(qhead) == "plain":
        return serve_enqueue_batch_plain(*args, live=live)
    from . import _cuda_bind
    out = _cuda_bind.serve_enqueue(_lib("serve_enqueue"), *args, live=live,
                                   batch=qhead.shape[0])
    launches["serve_enqueue_batch"] += 1
    return out


# --------------------------------------------------------------------------- #
# The tick's PFC stage: ingress byte accounting and the pause gates
# --------------------------------------------------------------------------- #

class PfcDims(NamedTuple):
    """Static inputs of the PFC stage."""

    n_tor: int
    n_spine: int
    n_hosts: int
    hosts_per_tor: int
    PD: int                 # pause-frame delay, ticks (pfc_line depth)
    buffer_bytes: float     # shared buffer per switch
    alpha: float            # dynamic threshold a * free / (1 + a)
    xon_frac: float         # resume below this fraction of xoff
    mtu_bytes: int


class PfcState(NamedTuple):
    """The fabric state the PFC stage reads and writes."""

    qbytes: torch.Tensor      # f32[Q+1]: wire bytes queued per row
    ing_host: torch.Tensor    # f32[NH]: bytes at ToR(h) from host h's NIC
    ing_sd: torch.Tensor      # f32[S, T]: bytes at ToR t from spine s
    ing_up: torch.Tensor      # f32[T, S]: bytes at spine s from ToR t
    paused_nic: torch.Tensor  # bool[NH]
    paused_sd: torch.Tensor   # bool[S, T]
    paused_up: torch.Tensor   # bool[T, S]
    pfc_line: torch.Tensor    # bool[max(PD, 1), NH + 2 TS]
    pauses: torch.Tensor      # i32


class PfcFlows(NamedTuple):
    """Per-run flow inputs of the PFC stage."""

    src: torch.Tensor         # i32[N]
    src_tor: torch.Tensor     # i32[N]
    same_tor: torch.Tensor    # bool[N]
    total_pkts: torch.Tensor  # i32[N]
    tail_b: torch.Tensor      # f32[N]
    by_src: torch.Tensor      # i32[N]: flows sorted by src, stable
    src_start: torch.Tensor   # i32[NH + 1]: offsets of each host in by_src


def pfc_flows(src, src_tor, same_tor, total_pkts, tail_b,
              index: SrcIndex) -> PfcFlows:
    """:class:`PfcFlows` of one run (the per-host lane lists from the
    program's :class:`SrcIndex`)."""
    return PfcFlows(src, src_tor, same_tor, total_pkts, tail_b, index.by_src,
                    index.src_start)


def _scatter_add(vec: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
                 ) -> torch.Tensor:
    """``vec.at[idx].add(val)`` with a trash slot at ``idx == len(vec)``,
    summed in index order."""
    out = torch.cat([vec, vec.new_zeros(1)])
    out.index_add_(0, idx.long(), val)
    return out[:vec.shape[0]]


def pfc_gate(paused, ingress_bytes, xoff_bytes, xon_frac: float):
    """One PFC hysteresis step, elementwise: pause above ``xoff``; once
    paused, resume only below ``xon_frac * xoff``."""
    pause = ingress_bytes > xoff_bytes
    resume = ingress_bytes < f32(xon_frac) * xoff_bytes
    return pause | (paused & (~resume))


@functools.lru_cache(maxsize=None)
def row_chunk(n: int) -> int:
    """The chunk in which the reference's program sums a row of ``n``
    floats: the largest divisor of ``n`` up to 32 (ROADMAP C16)."""
    return max(c for c in range(1, min(n, 32) + 1) if n % c == 0)


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` [R, n] summed as XLA's CPU reduction sums it inside
    the reference's tick: from zero, the row's chunks of
    :func:`row_chunk` ``(n)`` each summed from zero left to right, then
    the chunks' sums left to right (``torch.sum`` sums in another order,
    which a fractional tail shows in the last bit; ROADMAP C16)."""
    r, n = x.shape
    c = row_chunk(n) if n else 1
    chunks = x.reshape(r, n // c, c)
    part = x.new_zeros((r, n // c))
    for j in range(c):
        part = part + chunks[:, :, j]
    total = x.new_zeros((r,))
    for k in range(n // c):
        total = total + part[:, k]
    return total


def pfc_account_plain(st: PfcState, has, pop: PktQ, pop_bytes, cand_qid,
                      cand_bytes, accept, q: PktQ, qhead, qsize0, qsize,
                      t: int, fl: PfcFlows, d: PfcDims,
                      lanes=None) -> PfcState:
    """Stage 6b of the reference's tick: dequeues leave the ingress
    counter they entered by (the source NIC, the source ToR's uplink, or
    the spine of the injection-time spine lane), accepted candidates enter
    by their wire bytes; byte-accurate queue occupancy sets each switch's
    dynamic threshold ``xoff = a * max(buffer - occ, 0) / (1 + a)``; the
    gates chain on the switches' decision state, which the ``pfc_line``
    ring delays by ``PD`` ticks.  ``q``, ``qhead``, ``qsize`` (the ring
    after serve/enqueue) and ``qsize0`` (before) are read by the kernel
    only, which takes the accepted candidates' bytes back from the ring
    slots they were placed in (the same candidates in the same order).
    The NIC injections enter by their lanes' sources: ``lanes`` is the
    active set's slate (i32[L], padded with N), ``None`` for lane = flow."""
    T, S, NH, HPT = d.n_tor, d.n_spine, d.n_hosts, d.hosts_per_tor
    TS = T * S
    Q = 2 * TS + NH
    N = fl.src.shape[0]
    dev = has.device
    fclip = pop.flow.clamp(0, N - 1).long()
    f_up, f_sd, f_hd = fclip[:TS], fclip[TS:2 * TS], fclip[2 * TS:]
    ing_host = _scatter_add(st.ing_host,
                            torch.where(has[:TS], fl.src[f_up], NH),
                            -pop_bytes[:TS])
    sd_i = torch.arange(TS, dtype=torch.int32, device=dev)
    up_flat = _scatter_add(
        st.ing_up.reshape(-1),
        torch.where(has[TS:2 * TS], fl.src_tor[f_sd] * S + sd_i // T, TS),
        -pop_bytes[TS:2 * TS])
    hd_same = fl.same_tor[f_hd]
    served_hd = has[2 * TS:]
    host_tor = torch.arange(NH, dtype=torch.int32, device=dev) // HPT
    ing_host = _scatter_add(
        ing_host, torch.where(served_hd & hd_same, fl.src[f_hd], NH),
        -pop_bytes[2 * TS:])
    sd_flat = _scatter_add(
        st.ing_sd.reshape(-1),
        torch.where(served_hd & (~hd_same), pop.spine[2 * TS:] * T + host_tor,
                    TS),
        -pop_bytes[2 * TS:])
    up_flat = _scatter_add(up_flat, torch.where(accept[:TS], sd_i, TS),
                           cand_bytes[:TS])
    sd_flat = _scatter_add(sd_flat,
                           torch.where(accept[TS:2 * TS], sd_i, TS),
                           cand_bytes[TS:2 * TS])
    lane_src = (fl.src if lanes is None
                else fl.src[lanes.long().clamp(max=N - 1)])
    L = lane_src.shape[0]
    ing_host = _scatter_add(
        ing_host, torch.where(accept[2 * TS:2 * TS + L], lane_src, NH),
        cand_bytes[2 * TS:2 * TS + L])
    ing_host = _scatter_add(
        ing_host, torch.where(accept[2 * TS + L:], lane_src, NH),
        cand_bytes[2 * TS + L:])
    ing_sd, ing_up = sd_flat.reshape(S, T), up_flat.reshape(T, S)

    # the accepted bytes add into the occupancy one candidate at a time,
    # in candidate order: XLA folds the reference's ``qbytes +
    # segment_sum(...)`` into one scatter-add onto qbytes, and with a
    # fractional tail the order of the float adds shows (ROADMAP C14)
    qbytes = st.qbytes.clone()
    qbytes[:Q] += -torch.where(has, pop_bytes, 0.0)
    qbytes.index_add_(0, torch.where(accept, cand_qid, Q).long(),
                      torch.where(accept, cand_bytes, 0.0))
    qbytes[Q] = 0.0
    qb = qbytes[:Q]
    tor_occ = (row_sums(qb[:TS].reshape(T, S))
               + row_sums(qb[2 * TS:].reshape(T, HPT)))
    spine_occ = row_sums(qb[TS:2 * TS].reshape(S, T))
    a, inv = f32(d.alpha), recip32(1 + d.alpha)
    buf = f32(d.buffer_bytes)
    xoff_tor = a * torch.clamp_min(buf - tor_occ, 0.0) * inv
    xoff_spine = a * torch.clamp_min(buf - spine_occ, 0.0) * inv
    paused_nic = pfc_gate(st.paused_nic, ing_host, xoff_tor[host_tor.long()],
                          d.xon_frac)
    paused_sd = pfc_gate(st.paused_sd, ing_sd, xoff_tor[None, :], d.xon_frac)
    paused_up = pfc_gate(st.paused_up, ing_up, xoff_spine[None, :],
                         d.xon_frac)
    pauses = st.pauses + (
        (paused_nic & ~st.paused_nic).sum(dtype=torch.int32)
        + (paused_sd & ~st.paused_sd).sum(dtype=torch.int32)
        + (paused_up & ~st.paused_up).sum(dtype=torch.int32))
    pfc_line = st.pfc_line
    if d.PD > 0:
        pfc_line = pfc_line.clone()
        pfc_line[t % d.PD] = torch.cat([paused_nic, paused_sd.reshape(-1),
                                        paused_up.reshape(-1)])
    return PfcState(qbytes, ing_host, ing_sd, ing_up, paused_nic, paused_sd,
                    paused_up, pfc_line, pauses)


def pfc_account(st: PfcState, has, pop: PktQ, pop_bytes, cand_qid,
                cand_bytes, accept, q: PktQ, qhead, qsize0, qsize, t: int,
                fl: PfcFlows, d: PfcDims, lanes=None) -> PfcState:
    """The PFC stage: plain version on CPU tensors; on CUDA tensors one
    launch of ``csrc/serve_enqueue.cu`` (a warp per ToR and per spine
    hands each dequeued row's bytes to its ingress counter in row order,
    a thread per queue adds the accepted bytes; after a grid-wide barrier
    a warp per switch sums its occupancy once and steps its ports' gates;
    every counter sums its updates in the reference's order).  Returns the
    new state; the input state is left as it was.  Under the active set
    (``lanes``, the slate) each host's lane finds its flows' lanes by
    binary search in the ascending slate, held in shared memory, so it
    still sums its injections in lane order."""
    args = (st, has, pop, pop_bytes, cand_qid, cand_bytes, accept, q, qhead,
            qsize0, qsize, t, fl, d, lanes)
    if _route(has) == "plain":
        return pfc_account_plain(*args)
    from . import _cuda_bind
    out = _cuda_bind.pfc_account(_lib("serve_enqueue"), *args)
    launches["pfc_account"] += 1
    return out


def pfc_flows_batch(src, src_tor, same_tor, total_pkts, tail_b,
                    index: SrcIndex) -> PfcFlows:
    """The :class:`PfcFlows` of a batch ([B, N] inputs, ``index`` its
    :func:`src_index_batch`): each entry's lane lists in its own flow
    and host numbering (``by_src`` [B, N], ``src_start`` [B, NH + 1])."""
    b, n = src.shape
    nh = (index.src_start.shape[0] - 1) // b
    dev = src.device
    ent = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
    by_src = index.by_src.view(b, n) - ent * n
    at = ent * nh + torch.arange(nh + 1, dtype=torch.int32, device=dev)
    src_start = index.src_start[at.long()] - ent * n
    return PfcFlows(src, src_tor, same_tor, total_pkts, tail_b, by_src,
                    src_start)


def pfc_account_batch_plain(st: PfcState, has, pop: PktQ, pop_bytes,
                            cand_qid, cand_bytes, accept, q: PktQ, qhead,
                            qsize0, qsize, t: int, fl: PfcFlows, d: PfcDims,
                            live=None) -> PfcState:
    """:func:`pfc_account_plain` on each entry of a batch (every input
    with a leading axis B, ``fl`` from :func:`pfc_flows_batch`); a frozen
    entry (``live[b]`` False) keeps its state."""
    outs = []
    for b in range(has.shape[0]):
        st_b = _entry(st, b)
        new = pfc_account_plain(
            st_b, has[b], _entry(pop, b), pop_bytes[b], cand_qid[b],
            cand_bytes[b], accept[b], _entry(q, b), qhead[b], qsize0[b],
            qsize[b], t, _entry(fl, b), d)
        if live is not None:
            new = PfcState(*[torch.where(live[b], x, y)
                             for x, y in zip(new, st_b)])
        outs.append(new)
    return _stack(outs)


def pfc_account_batch(st: PfcState, has, pop: PktQ, pop_bytes, cand_qid,
                      cand_bytes, accept, q: PktQ, qhead, qsize0, qsize,
                      t: int, fl: PfcFlows, d: PfcDims,
                      live=None) -> PfcState:
    """The PFC stage on a batch of B entries at one tick: plain version
    on CPU tensors; on CUDA tensors one launch of ``csrc/serve_enqueue.cu``
    whose warps take B x (T + S) switches and B x (Q + 1) queues, each
    entry's switches summing only its own rows, through the same one
    grid-wide barrier.  Returns the new state; the input state is left as
    it was."""
    args = (st, has, pop, pop_bytes, cand_qid, cand_bytes, accept, q, qhead,
            qsize0, qsize, t, fl, d)
    _check_batch("live", live, torch.bool, (has.shape[0],), has.device)
    if _route(has) == "plain":
        return pfc_account_batch_plain(*args, live=live)
    from . import _cuda_bind
    out = _cuda_bind.pfc_account(_lib("serve_enqueue"), *args, live=live,
                                 batch=has.shape[0])
    launches["pfc_account_batch"] += 1
    return out


def _lib(name: str) -> ctypes.CDLL:
    """The loaded library of one fabric source."""
    from . import _cuda_bind
    return load(name, lambda lib: _cuda_bind.declare(name, lib))
