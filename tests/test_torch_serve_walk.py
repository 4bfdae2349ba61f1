"""The one-launch enqueue of ``csrc/serve_enqueue.cu``, modelled in numpy
step for step, against ``serve_enqueue_plain``'s rank-based accept and
placement.

On the card ``serve_enqueue`` is one launch.  After the serve phase and a
grid-wide barrier, each valid candidate takes a place in its queue's
bucket from an integer atomic, in no particular order: the first
``kBucket`` of a queue in that queue's fixed slots, any more in one
overflow list shared by every queue (in the order of a second atomic).
After a second barrier one thread a queue walks its bucket in candidate
order.  A bucket of at most ``kSmall`` is sorted in the thread's registers
by odd-even transposition (``kSmall`` passes over ``kSmall`` entries
padded with INT_MAX) and walked one candidate at a time.  A larger one is
taken by the whole warp: it reserves ``2 k`` entries of a staging area
(a third atomic), gathers the bucket there (its fixed slots, then its
entries of the overflow list, 32 at a time, filtered by ``cand_qid``),
writes each element at its rank among the bucket (counted 32 at a time)
into the second half, and walks that 32 candidates at a time, the rank
among the accepted from a ballot.

The model below follows those steps, with the constants read from the
CUDA source and the three atomics' orders drawn at random, and must give
the plain version's accept flags, drop count, queue sizes and ring
contents on random candidate sets: probes after data past ``data_drop``,
probes past ``hard``, a bucket on the warp path within the fixed slots,
every candidate in one queue (past the fixed slots), two queues whose
buckets share the overflow list, ring wrap-around, M
above and below 256, and lanes of the active set with padding.  Each case
asserts which of the walk's paths it took.  No JAX here: the plain
version is held against JAX by the fabric tests.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import fabric_kernels as fk
from repro_torch.numerics import Now

pytestmark = pytest.mark.torch

T, S, HPT = 4, 4, 4
TS, NH = T * S, T * HPT
Q = 2 * TS + NH
DATA_DROP, HARD = 6, 9
CAP = HARD + 8 + 2
SHARED = 2 * TS + 3  # the host-down row the crowded cases share (and +4)
INT_MAX = 0x7FFFFFFF


def _kernel_constant(name: str) -> int:
    src = (pathlib.Path(fk.__file__).parent / "csrc" / "serve_enqueue.cu"
           ).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


BUCKET, SMALL = _kernel_constant("kBucket"), _kernel_constant("kSmall")


def _popcount_lt(bal: int, lane: int) -> int:
    return bin(bal & ((1 << lane) - 1)).count("1")


def _sort_small(fx, k):
    """``walk_small``'s odd-even transposition in registers."""
    e = list(fx[:k]) + [INT_MAX] * (SMALL - k)
    for i in range(SMALL):
        for u in range(i & 1, SMALL - 1, 2):
            e[u], e[u + 1] = min(e[u], e[u + 1]), max(e[u], e[u + 1])
    return e[:k]


def _gather_and_sort(q, k, fixed, over, qid, stage, base):
    """``walk_bucket``'s gather into ``stage[base:base + k]`` and its sort
    by rank into ``stage[base + k:base + 2 k]``."""
    nf = min(k, BUCKET)
    stage[base:base + nf] = fixed[q, :nf]
    if k > BUCKET:
        at = base + nf
        for c in range(0, len(over), 32):
            mine = [e for e in over[c:c + 32] if qid[e] == q]
            stage[at:at + len(mine)] = mine
            at += len(mine)
        assert at == base + k
    buf = stage[base:base + k]
    for c0 in range(0, k, 32):  # each element's rank = its place
        for lane in range(min(32, k - c0)):
            x = buf[c0 + lane]
            pos = sum(int((buf[c1:c1 + 32] < x).sum())
                      for c1 in range(0, k, 32))
            stage[base + k + pos] = x
    return stage[base + k:base + 2 * k]


def model_enqueue(rng, qid, valid, probe, qsize1, qhead1, cap, data_drop,
                  hard):
    """The kernel's phases 2 and 3: ``(accept, drops, {e: (row, slot)},
    qsize, paths)``, ``paths`` the walks the buckets took ("small",
    "warp", "overflow": the warp's past the fixed slots; "shared
    overflow": the overflow list held two queues' candidates or more)."""
    m, nq = qid.shape[0], qsize1.shape[0]
    # phase 2: one atomic a candidate on its queue's count, in any order
    cnt = np.zeros(nq, np.int64)
    fixed = np.full((nq, BUCKET), -1, np.int64)
    over = []
    for i in rng.permutation(np.flatnonzero(valid)):
        s = cnt[qid[i]]
        cnt[qid[i]] += 1
        if s < BUCKET:
            fixed[qid[i], s] = i
        else:
            over.append(int(i))
    # phase 3: the large buckets' staging reserved in any order
    paths = set()
    stage = np.full(2 * m, -1, np.int64)
    base, at = {}, 0
    for q in rng.permutation(np.flatnonzero(cnt > SMALL)):
        base[q], at = at, at + 2 * cnt[q]
    assert at <= 2 * m
    if len({int(qid[i]) for i in over}) > 1:
        paths.add("shared overflow")  # the warps filter it by queue
    accept = valid.copy()
    placed, drops = {}, 0
    qsize = qsize1.copy()
    for q in range(nq):
        k = int(cnt[q])
        qs1, qh1 = (qsize1[q], qhead1[q]) if q < nq - 1 else (0, 0)
        n_acc = 0
        if 1 <= k <= SMALL:
            paths.add("small")
            for u, e in enumerate(_sort_small(fixed[q], k)):
                dropped = (not probe[e] and qs1 + u >= data_drop
                           or qs1 + u >= hard)
                accept[e] = not dropped
                if dropped:
                    drops += 1
                else:
                    placed[int(e)] = (q, (qh1 + qs1 + n_acc) % cap)
                    n_acc += 1
        elif k > SMALL:
            paths.add("overflow" if k > BUCKET else "warp")
            order = _gather_and_sort(q, k, fixed, over, qid, stage, base[q])
            for c0 in range(0, k, 32):  # 32 at a time, rank_a from a ballot
                chunk = order[c0:c0 + 32]
                occ = qs1 + c0 + np.arange(chunk.shape[0])
                dropped = ((~probe[chunk]) & (occ >= data_drop)) | (
                    occ >= hard)
                bal = sum(1 << j for j in range(chunk.shape[0])
                          if not dropped[j])
                for lane, e in enumerate(chunk):
                    accept[e] = not dropped[lane]
                    if accept[e]:
                        ra = n_acc + _popcount_lt(bal, lane)
                        placed[int(e)] = (q, (qh1 + qs1 + ra) % cap)
                drops += int(dropped.sum())
                n_acc += bin(bal).count("1")
        if q < nq - 1:
            qsize[q] = qs1 + n_acc
    return accept, drops, placed, qsize, paths


def _inputs(rng, L, case, lanes):
    """Random serve/enqueue inputs on a 4x4 fabric (Q = 48 rows) with L
    transport lanes: L flows on the dense program, or under the active set
    a slate of live flows of 2 L, ascending and padded.  Returns ``(args,
    keyword args)`` of ``serve_enqueue_plain``."""
    t, K = 40, 2
    n = 2 * L if lanes else L
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    ring = fk.PktQ(
        flow=i32(rng.integers(0, n, (Q + 1, CAP))),
        psn=i32(rng.integers(0, 40, (Q + 1, CAP))),
        ts=torch.from_numpy(rng.random((Q + 1, CAP)).astype(np.float32)),
        probe=torch.from_numpy(rng.random((Q + 1, CAP)) < 0.2),
        ecn=torch.from_numpy(rng.random((Q + 1, CAP)) < 0.3),
        ent=i32(rng.integers(0, 64, (Q + 1, CAP))),
        ready=i32(rng.integers(t - 3, t + 2, (Q + 1, CAP))),
        spine=i32(rng.integers(0, S, (Q + 1, CAP))))
    qhead = rng.integers(0, 5 * CAP, Q + 1)
    qsize = rng.integers(0, HARD, Q + 1)
    if case == "wrap":  # placements run past the ring's last slot
        qhead = CAP * rng.integers(1, 4, Q + 1) - rng.integers(1, 4, Q + 1)
    qhead[Q] = qsize[Q] = 0
    dst = rng.integers(0, NH, n)
    inj_q = rng.integers(0, Q, L)
    inj_qp = rng.integers(0, Q, L)
    sel = rng.random(L) < 0.6
    probe_valid = rng.random(L) < 0.5
    if case in ("data_drop", "warp"):
        # SHARED serves nothing and takes no advance.  data_drop: it holds
        # DATA_DROP - 2; four data lanes and two probes come in (a thread's
        # walk): occupancy 4, 5 accepted, 6, 7 dropped (data), 8 accepted
        # (a probe after the dropped data), 9 dropped (a probe at hard).
        # warp: it is empty; seven data lanes and three probes come in (the
        # warp's walk within the fixed slots): occupancy 0-5 accepted, 6
        # dropped, 7 and 8 accepted (probes), 9 dropped
        n_data, n_probe = (4, 2) if case == "data_drop" else (7, 3)
        dst = rng.integers(SHARED - 2 * TS + 1, NH, n)
        ring.ready[SHARED] = t + 1
        qsize[SHARED] = DATA_DROP - 2 if case == "data_drop" else 0
        inj_q = np.where(inj_q == SHARED, 0, inj_q)
        inj_qp = np.where(inj_qp == SHARED, 0, inj_qp)
        lanes_in = rng.choice(L - 3, n_data + n_probe, replace=False)
        inj_q[lanes_in[:n_data]] = SHARED
        sel[lanes_in[:n_data]] = True
        inj_qp[lanes_in[n_data:]] = SHARED
        probe_valid[lanes_in[n_data:]] = True
    elif case in ("hard", "one_queue"):
        share = rng.random(L) < (1.0 if case == "one_queue" else 0.5)
        inj_q = np.where(share, SHARED, inj_q)
        inj_qp = np.where(share, SHARED, inj_qp)
        if case == "hard":  # probes past hard
            qsize[SHARED] = DATA_DROP
            probe_valid = probe_valid | share
        else:
            qsize[SHARED] = 1
            sel = sel | share
    elif case == "two_queues":  # the overflow list holds both buckets' tails
        other = np.where(np.arange(L) % 2 == 0, SHARED, SHARED + 4)
        inj_q, inj_qp = other, other[::-1].copy()
        qsize[SHARED] = qsize[SHARED + 4] = 1
        sel, probe_valid = np.ones(L, bool), np.ones(L, bool)
    kw = dict(paused_row=torch.from_numpy(rng.random(Q) < 0.2)
              if case == "paused" else None)
    if lanes:  # the live flows, ascending, padded with n
        live = np.sort(rng.choice(n, L - 3, replace=False))
        idx = np.concatenate([live, np.full(3, n)])
        kw["lane_flow"] = i32(np.minimum(idx, n - 1))
        sel, probe_valid = sel & (idx < n), probe_valid & (idx < n)
    d = fk.ServeDims(n_tor=T, n_spine=S, n_hosts=NH, n_flows=n, cap=CAP, K=K,
                     data_drop_pkts=DATA_DROP, hard_pkts=HARD, kmin_p=2.0,
                     kmax_p=7.0, mtu_bytes=4096, tick_us=0.08)
    args = (ring, i32(qhead), i32(qsize), i32(dst), i32(dst // HPT),
            i32(rng.integers(1, 40, n)),
            torch.from_numpy(rng.uniform(64, 4096, n).astype(np.float32)),
            i32(rng.integers(0, 40, L)), i32(rng.integers(0, 40, L)),
            i32(rng.integers(0, 64, L)), i32(rng.integers(0, 64, L)),
            i32(rng.integers(0, S, L)), i32(rng.integers(0, S, L)),
            torch.from_numpy(sel), torch.from_numpy(probe_valid), i32(inj_q),
            i32(inj_qp), t, d)
    return args, kw


def _cand_fields(e, res, args, lane_flow):
    """Candidate e's ring fields, as the kernel's ``place`` writes them."""
    pop, ecn_out, t, d = res[2], res[4], args[17], args[18]
    if e < 2 * TS:
        return (int(pop.flow[e]), int(pop.psn[e]), float(pop.ts[e]),
                bool(pop.probe[e]), bool(ecn_out[e]), int(pop.ent[e]),
                t + 1 + d.K, int(pop.spine[e]))
    L = args[13].shape[0]
    l, is_probe = e - 2 * TS, e - 2 * TS >= L
    l -= L if is_probe else 0
    flow = int(lane_flow[l]) if lane_flow is not None else l
    now = float(torch.tensor(float(Now(t, d.tick_us)), dtype=torch.float32))
    return (flow, int(args[8 if is_probe else 7][l]), now, is_probe, False,
            int(args[10 if is_probe else 9][l]), t + 1 + d.K,
            int(args[12 if is_probe else 11][l]))


# L = 64 lanes: M = 2 TS + 2 L = 160 candidates (the reference's all-pairs
# count); L = 200: M = 432 (its chunked ranker)
CASES = [(case, L) for case in ("random", "data_drop", "hard", "one_queue",
                                "wrap") for L in (64, 200)] + [
    ("paused", 200), ("warp", 64), ("warp", 200), ("two_queues", 64),
    ("two_queues", 200)]


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("case,L", CASES)
def test_bucket_walk_matches_the_plain_enqueue(case, L, lanes):
    rng = np.random.default_rng([CASES.index((case, L)), int(lanes)])
    args, kw = _inputs(rng, L, case, lanes)
    ring0 = fk.PktQ(*[f.clone() for f in args[0]])
    res = fk.serve_enqueue_plain(*args, **kw)
    qid = res[6].numpy().astype(np.int64)
    assert qid.shape[0] == 2 * TS + 2 * L
    has, surv, acc_p = res[3].numpy(), res[10].numpy(), res[7].numpy()
    valid = np.concatenate([surv[:2 * TS], args[13].numpy(),
                            args[14].numpy()])
    probe = np.concatenate([res[2].probe[:2 * TS].numpy(),
                            np.zeros(L, bool), np.ones(L, bool)])
    qsize1 = args[2].numpy().astype(np.int64)
    qsize1[:Q] -= has
    qhead1 = args[1].numpy().astype(np.int64)
    qhead1[:Q] += has
    for _ in range(3):  # three orders of the atomics
        accept, drops, placed, qsize, paths = model_enqueue(
            rng, qid, valid, probe, qsize1, qhead1, CAP, DATA_DROP, HARD)
        np.testing.assert_array_equal(accept, acc_p)
        assert drops == int(res[8])
        np.testing.assert_array_equal(qsize[:Q], res[1][:Q].numpy())
        ring = [f.clone() for f in ring0]
        for e, (q, pos) in placed.items():
            for f, v in zip(ring, _cand_fields(e, res, args,
                                               kw.get("lane_flow"))):
                f[q, pos] = v
        for name, a, b in zip(fk.PktQ._fields, ring, args[0]):
            assert torch.equal(a[:Q], b[:Q]), name
    # the case happened
    in_r = valid & (qid == SHARED)
    if case == "one_queue":
        assert in_r.sum() >= L and "overflow" in paths
    if case == "two_queues":
        assert "shared overflow" in paths
    assert "small" in paths
    if case == "data_drop":  # data, data, drop, drop, probe, probe past hard
        np.testing.assert_array_equal(acc_p[in_r], [1, 1, 0, 0, 1, 0])
        np.testing.assert_array_equal(probe[in_r], [0, 0, 0, 0, 1, 1])
    if case == "warp":  # six data, a dropped one, two probes, one past hard
        np.testing.assert_array_equal(acc_p[in_r],
                                      [1, 1, 1, 1, 1, 1, 0, 1, 1, 0])
        np.testing.assert_array_equal(probe[in_r], [0] * 7 + [1] * 3)
        assert "warp" in paths and SMALL < 10 <= BUCKET
    if case == "hard":
        assert (in_r & ~acc_p & probe).any()
    if case == "wrap":
        assert any(pos < qhead1[q] % CAP for q, pos in placed.values())
    if case == "paused":
        assert bool((kw["paused_row"] & (args[2][:Q] > 0)).any())
