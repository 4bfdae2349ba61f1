"""Collective-algorithm trace generators (paper Section 4.3): a copy of
``repro.collective.algorithms`` on the port's ``Message``.

Each generator emits a list of ``Message`` records with dependency edges
exactly as the paper describes: "messages from later steps are sent only
after messages in previous steps are received".  Messages are chunked (the
paper uses 128 KB chunks "to utilize the pipeline") — chunk c of step s
depends on chunk c of step s-1, which pipelines the steps.

Algorithms: Ring / DoubleBinaryTree / HalvingDoubling AllReduce, and
windowed AlltoAll (sequenced (n+1), (n+2), ... with a bounded number of
active connections, the paper's incast-avoidance ordering).
"""
from __future__ import annotations

import math

from ..sim.workloads import Message


def _flat(deps):
    return [x for e in deps for x in (e if isinstance(e, list) else [e])]


class _Trace:
    def __init__(self, group):
        self.msgs: list[Message] = []
        self.group = group

    def add(self, src, dst, size, deps=None, chunk=None):
        """Add one message (optionally chunked); returns its msg ids.

        ``deps`` elements may be ints or lists of ids (a chunked parent).
        A chunked message's chunk c depends on the parent's chunk c when
        chunk counts match (step pipelining), else on all parent chunks."""
        deps = list(deps or [])
        if chunk is None or size <= chunk:
            m = Message(mid=len(self.msgs), src=src, dst=dst, size=size,
                        deps=_flat(deps), group=self.group)
            self.msgs.append(m)
            return [m.mid]
        n = math.ceil(size / chunk)
        ids = []
        for c in range(n):
            sz = min(chunk, size - c * chunk)
            dd = []
            for e in deps:
                if isinstance(e, list) and len(e) == n:
                    dd.append(e[c])          # pipeline chunk-to-chunk
                elif isinstance(e, list):
                    dd.extend(e)
                else:
                    dd.append(e)
            m = Message(mid=len(self.msgs), src=src, dst=dst, size=sz,
                        deps=dd, group=self.group)
            self.msgs.append(m)
            ids.append(m.mid)
        return ids


def ring_allreduce(n: int, total_bytes: float, group: int = 0,
                   chunk: float = 128 * 1024) -> list[Message]:
    """Ring: reduce-scatter (n-1 steps) + all-gather (n-1 steps)."""
    tr = _Trace(group)
    seg = total_bytes / n
    prev: dict[int, list] = {r: None for r in range(n)}
    for step in range(2 * (n - 1)):
        new_prev = {}
        for r in range(n):
            deps = [prev[(r - 1) % n]] if prev[(r - 1) % n] else []
            new_prev[r] = tr.add(r, (r + 1) % n, seg, deps=deps, chunk=chunk)
        prev = new_prev
    return tr.msgs


def _btree_children(n, root_shift=0):
    """Complete binary tree over ranks (heap layout), shifted."""
    par = {}
    for i in range(n):
        p = (i - 1) // 2 if i > 0 else None
        par[(i + root_shift) % n] = ((p + root_shift) % n
                                     if p is not None else None)
    return par


def dbt_allreduce(n: int, total_bytes: float, group: int = 0,
                  chunk: float = 128 * 1024) -> list[Message]:
    """DoubleBinaryTree: two trees, half the payload each; reduce to root
    then broadcast (the 2:1 incast pattern the paper highlights)."""
    tr = _Trace(group)
    half = total_bytes / 2
    for shift in (0, n // 2):
        parent = _btree_children(n, shift)
        children: dict[int, list[int]] = {r: [] for r in range(n)}
        for c, p in parent.items():
            if p is not None:
                children[p].append(c)
        # reduce: leaves up
        up_ids: dict[int, list] = {}

        def reduce_up(r):
            deps = []
            for c in children[r]:
                if c not in up_ids:
                    reduce_up(c)
                deps.append(up_ids[c])
            p = parent[r]
            if p is not None:
                up_ids[r] = tr.add(r, p, half, deps=deps, chunk=chunk)
        root = next(r for r, p in parent.items() if p is None)
        for r in range(n):
            if r != root and r not in up_ids:
                reduce_up(r)
        # broadcast: root down
        down_ids: dict[int, list] = {root: up_ids.get(root) or []}

        def bcast(r, dep):
            for c in children[r]:
                down_ids[c] = tr.add(r, c, half, deps=dep, chunk=chunk)
                bcast(c, down_ids[c])
        root_dep = []
        for c in children[root]:
            root_dep.append(up_ids[c])
        bcast(root, [d for ids in root_dep for d in
                     (ids if isinstance(ids, list) else [ids])]
              if root_dep else [])
    return tr.msgs


def hd_allreduce(n: int, total_bytes: float, group: int = 0,
                 chunk: float = 128 * 1024) -> list[Message]:
    """HalvingDoubling: log2(n) RS rounds + log2(n) AG rounds (XOR pairs)."""
    assert n & (n - 1) == 0, "HD needs power-of-two ranks"
    tr = _Trace(group)
    rounds = int(math.log2(n))
    prev = {r: None for r in range(n)}
    size = total_bytes / 2
    for k in range(rounds):                     # reduce-scatter, halving
        new_prev = {}
        for r in range(n):
            peer = r ^ (1 << k)
            deps = [prev[r]] if prev[r] else []
            new_prev[r] = tr.add(r, peer, size, deps=deps, chunk=chunk)
        prev = new_prev
        size /= 2
    size *= 2
    for k in reversed(range(rounds)):           # all-gather, doubling
        new_prev = {}
        for r in range(n):
            peer = r ^ (1 << k)
            deps = [prev[r]] if prev[r] else []
            new_prev[r] = tr.add(r, peer, size, deps=deps, chunk=chunk)
        prev = new_prev
        size *= 2
    return tr.msgs


def alltoall(n: int, total_bytes: float, group: int = 0,
             window: int = 32, chunk: float = 128 * 1024
             ) -> list[Message]:
    """AlltoAll, sequenced (n+1),(n+2),... with ≤ ``window`` active
    connections per sender/receiver (paper's incast-ordering)."""
    tr = _Trace(group)
    per = total_bytes / max(n - 1, 1)
    pending: dict[int, list] = {r: [] for r in range(n)}
    for j in range(1, n):
        for r in range(n):
            dst = (r + j) % n
            deps = []
            if j > window:
                deps = pending[r][j - window - 1]
            ids = tr.add(r, dst, per, deps=deps, chunk=chunk)
            pending[r].append(ids)
    return tr.msgs


ALGOS = {"ring": ring_allreduce, "dbt": dbt_allreduce, "hd": hd_allreduce,
         "a2a": alltoall}


def multi_job(algo: str, n_jobs: int, ranks_per_job: int, n_hosts: int,
              collective_bytes: float, seed: int = 0, hosts=None, **kw):
    """The paper's multi-job setup: ``n_jobs`` identical collectives,
    each group randomly placed on the cluster. Returns (messages,
    placement) where placement maps global rank-id -> host.

    ``hosts`` pins the placement instead of shuffling: an explicit host
    list (rank ``j * ranks_per_job + r`` lands on ``hosts[...]``), so a
    caller can reuse one placement across repeated generations — the
    multi-tenant traffic generator keeps each job's placement stable
    across soak epochs this way.

    ``workloads.collective_scenario`` wraps this into a
    :class:`~repro_torch.sim.workloads.Scenario` (hosts resolved, deps
    kept)."""
    import random
    if hosts is None:
        rng = random.Random(seed)
        hosts = list(range(n_hosts))
        rng.shuffle(hosts)
    else:
        hosts = list(hosts)
        assert len(hosts) >= n_jobs * ranks_per_job, \
            "pinned placement smaller than the job's rank count"
    assert n_jobs * ranks_per_job <= n_hosts
    msgs: list[Message] = []
    placement: dict[int, int] = {}
    gen = ALGOS[algo]
    for j in range(n_jobs):
        sub = gen(ranks_per_job, collective_bytes, group=j, **kw)
        base = len(msgs)
        rank_base = j * ranks_per_job
        for m in sub:
            msgs.append(Message(
                mid=m.mid + base, src=m.src + rank_base,
                dst=m.dst + rank_base, size=m.size,
                deps=tuple(d + base for d in m.deps), group=j))
        for r in range(ranks_per_job):
            placement[rank_base + r] = hosts[rank_base + r]
    return msgs, placement
