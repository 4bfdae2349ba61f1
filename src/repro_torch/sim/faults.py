"""Time-varying fault injection for the fabric: the port of
``repro.sim.faults``.

Three fault classes, each *program data* of fixed shape (entry counts are
static; times, probabilities and the seed are values):

* **flaps**: a link is down for ticks ``[t0, t1)``.  Packets served by a
  down queue row are blackholed (they left the buffer and never arrive);
  NIC injection onto a down host uplink is blackholed after the flow
  commits its send state, so senders discover the loss through silence,
  then RTO / SACK / go-back-N.  A flapped uplink leaves the ECMP and
  spray candidate set of its ToR while it is down.
* **degrades**: a ToR<->spine link serves at a fractional credit ``c in
  (0, 1]``: inside the window its queues pop a head only on ticks where
  ``floor((t+1) * c * 256) / 256`` advances (:func:`duty_open`).
* **corruption**: each data packet served by the link is dropped with
  probability ``p``, drawn from a counter-based splitmix64 keyed by
  ``(seed, queue row, tick, psn)`` (:func:`fault_u01`).

Links are named by topology coordinates: a ToR<->spine link ``(tor,
spine)`` covers both directions (the ``tor_up`` and ``spine_down`` queue
rows), a host link covers the NIC uplink and the ``host_down`` row.

The port keeps its own copy of the reference module (which imports jax),
with :func:`fault_u01` in plain PyTorch and :func:`build_fault_data`
returning tensors on an explicit device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from .topology import FatTree

__all__ = [
    "FaultSpec", "FaultData", "build_fault_data", "validate_faults",
    "fault_u01", "fault_u01_py", "duty_open", "duty_open_py", "link_flap",
    "uplink_flap", "host_flap", "link_degrade", "link_corrupt",
    "host_corrupt", "faults_from_dead_links", "NEVER",
]

#: Sentinel window end for permanent faults ("down from t0, forever").
#: ``last_edge`` counts such windows by their start.
NEVER = 2 ** 30


@dataclass(frozen=True)
class FaultSpec:
    """A complete time-varying fault schedule (all times in fabric ticks).

    * ``link_flaps``:   ``(tor, spine, t0, t1)``: link down in [t0, t1),
      both directions (the ``tor_up`` and ``spine_down`` rows blackhole)
    * ``uplink_flaps``: ``(tor, spine, t0, t1)``: only the ``tor_up``
      direction dies and leaves the ECMP candidate set (static
      ``dead_links`` semantics made time-varying)
    * ``host_flaps``:   ``(host, t0, t1)``: host<->ToR link down
    * ``link_degrade``: ``(tor, spine, t0, t1, credit)``: fractional
      service credit in (0, 1] while the window is active
    * ``link_corrupt``: ``(tor, spine, t0, t1, prob)``: per-packet drop
      probability in [0, 1] while active
    * ``host_corrupt``: ``(host, t0, t1, prob)``: the same, on the
      host-down (last-hop) link
    * ``seed``: the corruption draw's seed
    """

    link_flaps: Tuple[Tuple[int, int, int, int], ...] = ()
    uplink_flaps: Tuple[Tuple[int, int, int, int], ...] = ()
    host_flaps: Tuple[Tuple[int, int, int], ...] = ()
    link_degrade: Tuple[Tuple[int, int, int, int, float], ...] = ()
    link_corrupt: Tuple[Tuple[int, int, int, int, float], ...] = ()
    host_corrupt: Tuple[Tuple[int, int, int, float], ...] = ()
    seed: int = 0

    def __post_init__(self):
        ints = lambda es: tuple(tuple(int(v) for v in e) for e in es)
        object.__setattr__(self, "link_flaps", ints(self.link_flaps))
        object.__setattr__(self, "uplink_flaps", ints(self.uplink_flaps))
        object.__setattr__(self, "host_flaps", ints(self.host_flaps))
        object.__setattr__(
            self, "link_degrade",
            tuple((int(t), int(s), int(a), int(b), float(c))
                  for (t, s, a, b, c) in self.link_degrade))
        object.__setattr__(
            self, "link_corrupt",
            tuple((int(t), int(s), int(a), int(b), float(p))
                  for (t, s, a, b, p) in self.link_corrupt))
        object.__setattr__(
            self, "host_corrupt",
            tuple((int(h), int(a), int(b), float(p))
                  for (h, a, b, p) in self.host_corrupt))

    @property
    def seed32(self) -> int:
        """The seed as the draw keys it (31 bits, non-negative)."""
        return self.seed & 0x7FFFFFFF

    @property
    def shape_key(self) -> tuple:
        """Entry counts only: the static shape of the schedule."""
        return (len(self.link_flaps), len(self.uplink_flaps),
                len(self.host_flaps), len(self.link_degrade),
                len(self.link_corrupt), len(self.host_corrupt))

    @property
    def total_entries(self) -> int:
        return sum(self.shape_key)

    @property
    def n_flap_windows(self) -> int:
        """Windows with per-window retransmit attribution (link flaps,
        then uplink flaps, then host flaps)."""
        return (len(self.link_flaps) + len(self.uplink_flaps)
                + len(self.host_flaps))

    @property
    def last_edge(self) -> int:
        """Latest schedule boundary (0 for an empty spec), which extends
        the default tick horizon; windows ending at or after
        :data:`NEVER` count their start."""
        def _end(t0, t1):
            return t0 if t1 >= NEVER else t1
        edges = [0]
        edges += [_end(a, b) for (_t, _s, a, b) in self.link_flaps]
        edges += [_end(a, b) for (_t, _s, a, b) in self.uplink_flaps]
        edges += [_end(a, b) for (_h, a, b) in self.host_flaps]
        edges += [_end(a, b) for (_t, _s, a, b, _c) in self.link_degrade]
        edges += [_end(a, b) for (_t, _s, a, b, _p) in self.link_corrupt]
        edges += [_end(a, b) for (_h, a, b, _p) in self.host_corrupt]
        return max(edges)


def link_flap(tor: int, spine: int, t0: int, t1: int, **kw) -> FaultSpec:
    return FaultSpec(link_flaps=((tor, spine, t0, t1),), **kw)


def uplink_flap(tor: int, spine: int, t0: int, t1: int, **kw) -> FaultSpec:
    return FaultSpec(uplink_flaps=((tor, spine, t0, t1),), **kw)


def host_flap(host: int, t0: int, t1: int, **kw) -> FaultSpec:
    return FaultSpec(host_flaps=((host, t0, t1),), **kw)


def link_degrade(tor: int, spine: int, t0: int, t1: int,
                 credit: float, **kw) -> FaultSpec:
    return FaultSpec(link_degrade=((tor, spine, t0, t1, credit),), **kw)


def link_corrupt(tor: int, spine: int, t0: int, t1: int,
                 prob: float, seed: int = 0, **kw) -> FaultSpec:
    return FaultSpec(link_corrupt=((tor, spine, t0, t1, prob),),
                     seed=seed, **kw)


def host_corrupt(host: int, t0: int, t1: int, prob: float,
                 seed: int = 0, **kw) -> FaultSpec:
    return FaultSpec(host_corrupt=((host, t0, t1, prob),), seed=seed, **kw)


def faults_from_dead_links(topo: FatTree, t1: int = NEVER) -> FaultSpec:
    """The t=0 schedule of a topology's static ``dead_links``: each
    becomes an uplink flap from tick 0 that never recovers (run it on the
    same topology with every link alive)."""
    return FaultSpec(uplink_flaps=tuple(
        (t, s, 0, t1) for (t, s) in sorted(topo.dead_links)))


def validate_faults(spec: FaultSpec, topo: FatTree) -> None:
    """Range checks, and the no-partition rule: at no tick may a ToR lose
    its last live uplink (static dead links plus simultaneous flaps)."""
    T, S, NH = topo.n_tor, topo.n_spine, topo.n_hosts

    def _ck_link(tor, spine, what):
        if not (0 <= tor < T and 0 <= spine < S):
            raise ValueError(f"{what}: link ({tor},{spine}) out of range "
                             f"for {T} ToRs x {S} spines")

    def _ck_win(t0, t1, what):
        # an empty window (t0 == t1) is legal: an inert entry
        if not (0 <= t0 <= t1):
            raise ValueError(f"{what}: window [{t0},{t1}) is negative")

    for (t, s, a, b) in spec.link_flaps:
        _ck_link(t, s, "link_flap"); _ck_win(a, b, "link_flap")
        if (t, s) in topo.dead_links:
            raise ValueError(f"link_flap ({t},{s}): link is already in "
                             f"topo.dead_links")
    for (t, s, a, b) in spec.uplink_flaps:
        _ck_link(t, s, "uplink_flap"); _ck_win(a, b, "uplink_flap")
        if (t, s) in topo.dead_links:
            raise ValueError(f"uplink_flap ({t},{s}): link is already in "
                             f"topo.dead_links")
    for (h, a, b) in spec.host_flaps:
        if not 0 <= h < NH:
            raise ValueError(f"host_flap: host {h} out of range")
        _ck_win(a, b, "host_flap")
    for (t, s, a, b, c) in spec.link_degrade:
        _ck_link(t, s, "link_degrade"); _ck_win(a, b, "link_degrade")
        if not 0.0 < c <= 1.0:
            raise ValueError(f"link_degrade credit {c} not in (0, 1]")
    for (t, s, a, b, p) in spec.link_corrupt:
        _ck_link(t, s, "link_corrupt"); _ck_win(a, b, "link_corrupt")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"link_corrupt prob {p} not in [0, 1]")
    for (h, a, b, p) in spec.host_corrupt:
        if not 0 <= h < NH:
            raise ValueError(f"host_corrupt: host {h} out of range")
        _ck_win(int(a), int(b), "host_corrupt")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"host_corrupt prob {p} not in [0, 1]")
    all_flaps = spec.link_flaps + spec.uplink_flaps
    if all_flaps:
        edges = sorted({e for (_, _, a, b) in all_flaps for e in (a, b)})
        for t in range(T):
            live = set(topo.live_up[t])
            flaps = [(s, a, b) for (tt, s, a, b) in all_flaps if tt == t]
            for e in edges:
                down = {s for (s, a, b) in flaps if a <= e < b}
                if live and not (live - down):
                    raise ValueError(
                        f"link_flaps fully disconnect ToR {t} at tick {e};"
                        f" a partitioned ToR can never drain")


class FaultData(NamedTuple):
    """The schedule as the fabric reads it, resolved to queue rows
    (``tor_up`` ``t*S+s`` | ``spine_down`` ``TS+s*T+t`` | ``host_down``
    ``2*TS+h``); every tensor is i32 except ``cor_p`` (f32)."""

    seed: int              # the draw's seed (31 bits)
    flap_row: torch.Tensor   # queue rows down in [t0, t1)
    flap_row_t0: torch.Tensor
    flap_row_t1: torch.Tensor
    flap_nic: torch.Tensor   # hosts whose NIC uplink is down
    flap_nic_t0: torch.Tensor
    flap_nic_t1: torch.Tensor
    flap_up: torch.Tensor    # flat t*S+s uplinks out of ECMP while down
    flap_up_t0: torch.Tensor
    flap_up_t1: torch.Tensor
    deg_row: torch.Tensor    # degraded rows
    deg_t0: torch.Tensor
    deg_t1: torch.Tensor
    deg_num: torch.Tensor    # credit numerator out of 256
    cor_row: torch.Tensor    # corrupting rows
    cor_t0: torch.Tensor
    cor_t1: torch.Tensor
    cor_p: torch.Tensor      # f32
    edges: torch.Tensor      # every t0/t1 (warp wake sources)
    win_t0: torch.Tensor     # flap windows (retransmit attribution)
    win_t1: torch.Tensor


def build_fault_data(spec: Optional[FaultSpec], n_tor: int, n_spine: int,
                     hosts_per_tor: int, device="cpu") -> FaultData:
    """Expand a spec to queue-row-resolved tensors on ``device`` (an empty
    spec gives zero-length tensors).  ``hosts_per_tor`` is unused, as in
    the reference (host rows are ``2*TS + host``)."""
    del hosts_per_tor
    spec = spec or FaultSpec()
    T, S = n_tor, n_spine
    TS = T * S
    rows, r0, r1 = [], [], []
    ups, u0, u1 = [], [], []
    for (t, s, a, b) in spec.link_flaps:
        rows += [t * S + s, TS + s * T + t]     # both directions die
        r0 += [a, a]; r1 += [b, b]
        ups.append(t * S + s); u0.append(a); u1.append(b)
    for (t, s, a, b) in spec.uplink_flaps:
        rows.append(t * S + s)                  # up direction only
        r0.append(a); r1.append(b)
        ups.append(t * S + s); u0.append(a); u1.append(b)
    nics, n0, n1 = [], [], []
    for (h, a, b) in spec.host_flaps:
        rows.append(2 * TS + h); r0.append(a); r1.append(b)
        nics.append(h); n0.append(a); n1.append(b)
    dr, d0, d1, dn = [], [], [], []
    for (t, s, a, b, c) in spec.link_degrade:
        num = max(1, min(256, int(round(c * 256))))
        dr += [t * S + s, TS + s * T + t]
        d0 += [a, a]; d1 += [b, b]; dn += [num, num]
    cr, c0, c1, cp = [], [], [], []
    for (t, s, a, b, p) in spec.link_corrupt:
        cr += [t * S + s, TS + s * T + t]
        c0 += [a, a]; c1 += [b, b]; cp += [p, p]
    for (h, a, b, p) in spec.host_corrupt:
        cr.append(2 * TS + h); c0.append(int(a)); c1.append(int(b))
        cp.append(p)
    # not deduplicated, as in the reference: duplicate wake sources are
    # harmless mins
    edges = r0 + r1 + d0 + d1 + c0 + c1
    wt0 = [a for (_, _, a, _) in spec.link_flaps] \
        + [a for (_, _, a, _) in spec.uplink_flaps] \
        + [a for (_, a, _) in spec.host_flaps]
    wt1 = [b for (_, _, _, b) in spec.link_flaps] \
        + [b for (_, _, _, b) in spec.uplink_flaps] \
        + [b for (_, _, b) in spec.host_flaps]
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=device)
    return FaultData(
        seed=spec.seed32,
        flap_row=i32(rows), flap_row_t0=i32(r0), flap_row_t1=i32(r1),
        flap_nic=i32(nics), flap_nic_t0=i32(n0), flap_nic_t1=i32(n1),
        flap_up=i32(ups), flap_up_t0=i32(u0), flap_up_t1=i32(u1),
        deg_row=i32(dr), deg_t0=i32(d0), deg_t1=i32(d1), deg_num=i32(dn),
        cor_row=i32(cr), cor_t0=i32(c0), cor_t1=i32(c1),
        cor_p=torch.tensor(cp, dtype=torch.float32, device=device),
        edges=i32(edges), win_t0=i32(wt0), win_t1=i32(wt1))


def duty_open(t, num: torch.Tensor) -> torch.Tensor:
    """True on ticks where a ``num/256`` duty cycle grants a service slot
    (the credit integral crosses an integer); int32 arithmetic, as in the
    reference."""
    fl = lambda x: torch.div(x, 256, rounding_mode="floor")
    return fl((t + 1) * num) > fl(t * num)


def duty_open_py(t: int, num: int) -> bool:
    return ((t + 1) * num) // 256 > (t * num) // 256


# --------------------------------------------------------------------------- #
# Counter-based splitmix64 on two uint32 limbs held in int64 tensors
# --------------------------------------------------------------------------- #

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_GOLDEN = (0x9E3779B9, 0x7F4A7C15)
_C1 = (0xBF58476D, 0x1CE4E5B9)
_C2 = (0x94D049BB, 0x133111EB)


def _mullo32(a, b):
    """``a * b mod 2^32`` for limbs below 2^32, from 16-bit partial
    products (each below 2^32, so no int64 product overflows)."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    return (a0 * b0 + (((a0 * b1 + a1 * b0) & _M16) << 16)) & _M32


def _mul64(ah, al, bh, bl):
    """``(ah<<32|al) * (bh<<32|bl) mod 2^64`` on 32-bit limbs (the
    reference's 16-bit partial-product scheme; its uint32 wrap-around is
    a mask here)."""
    a0, a1 = al & _M16, al >> 16
    b0, b1 = bl & _M16, bl >> 16
    p00, p01, p10 = a0 * b0, a0 * b1, a1 * b0
    mid = (p00 >> 16) + (p01 & _M16) + (p10 & _M16)
    lo = (p00 & _M16) | ((mid & _M16) << 16)
    hi = ((mid >> 16) + (p01 >> 16) + (p10 >> 16) + a1 * b1
          + _mullo32(al, bh) + _mullo32(ah, bl)) & _M32
    return hi, lo


def _add64(ah, al, bh, bl):
    lo = (al + bl) & _M32
    carry = (lo < al).to(torch.int64)
    return (ah + bh + carry) & _M32, lo


def _xorshift64(h, l, k: int):
    """``x ^= x >> k`` for 0 < k < 32 (logical shifts of the limbs)."""
    sh = h >> k
    sl = (l >> k) | ((h << (32 - k)) & _M32)
    return h ^ sh, l ^ sl


def _splitmix64(h, l):
    """Advance the state by the golden gamma and mix: (state, output)."""
    h, l = _add64(h, l, *_GOLDEN)
    zh, zl = _xorshift64(h, l, 30)
    zh, zl = _mul64(zh, zl, *_C1)
    zh, zl = _xorshift64(zh, zl, 27)
    zh, zl = _mul64(zh, zl, *_C2)
    return (h, l), _xorshift64(zh, zl, 31)


def _limb(x, device) -> torch.Tensor:
    """A counter cast to uint32 as the reference's ``astype(jnp.uint32)``
    does (a negative int32 wraps to 2^32 + c), held in int64."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def fault_u01(seed, *counters) -> torch.Tensor:
    """f32 in [0, 1) from the top 24 bits of the keyed splitmix64 stream,
    bit for bit the reference's ``fault_u01``: the state is two uint32
    limbs in int64 tensors, masked to 32 bits after every add, multiply
    and shift; each counter is cast to uint32 first."""
    dev = next((c.device for c in counters if isinstance(c, torch.Tensor)),
               None)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    _, (oh, ol) = _splitmix64(zero, _limb(seed, dev))
    for c in counters:
        ch, cl = _mul64(zero, _limb(c, dev), *_GOLDEN)
        _, (oh, ol) = _splitmix64(oh ^ ch, ol ^ cl)
    return (oh >> 8).to(torch.float32) * (1.0 / (1 << 24))


_MASK64 = (1 << 64) - 1
_GOLDEN64 = 0x9E3779B97F4A7C15


def splitmix64(x: int) -> int:
    """One splitmix64 output step (Steele et al.): u64 -> u64."""
    x = (x + _GOLDEN64) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def _u64(seed: int, *counters: int) -> int:
    """Stateless draw: hash the (seed, counters...) key path."""
    state = splitmix64(seed & _MASK64)
    for c in counters:
        state = splitmix64(state ^ ((c & _MASK64) * _GOLDEN64 & _MASK64))
    return state


def fault_u01_py(seed: int, *counters: int) -> float:
    """Host mirror of :func:`fault_u01` (equal for non-negative counters;
    a negative counter is masked to 64 bits here, to 32 there)."""
    return float(_u64(seed, *counters) >> 40) * (1.0 / (1 << 24))
