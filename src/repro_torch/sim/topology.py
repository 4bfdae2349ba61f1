"""2-tier fat-tree (Clos) topology with ECMP, oversubscription, link failures.

Matches the paper's evaluation fabric (Section 4.2): hosts -> ToR -> spine,
all links the same speed; oversubscription trims spine count; asymmetry
disables chosen ToR-spine links.  Path selection is ECMP: a deterministic
hash of (src, dst, entropy) over the *live* uplinks.

This Python model is the shared ground truth for both simulator backends:
``events.py`` consumes it directly, and ``fabric.py`` array-izes it
(``ArrayTopo.from_fat_tree``) with a bit-exact tensor mirror of ``_mix``.

The port keeps its own copy of ``repro.sim.topology`` (same classes, same
hash) so that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses


def _mix(a: int, b: int, c: int) -> int:
    """Deterministic 32-bit hash mix (Knuth multiplicative + xors)."""
    h = (a * 2654435761) & 0xFFFFFFFF
    h ^= (b * 2246822519) & 0xFFFFFFFF
    h = (h * 3266489917) & 0xFFFFFFFF
    h ^= (c * 668265263) & 0xFFFFFFFF
    h = (h * 374761393) & 0xFFFFFFFF
    return (h >> 8) ^ (h & 0xFF)


@dataclasses.dataclass
class FatTree:
    n_tor: int = 8
    hosts_per_tor: int = 8
    n_spine: int = 8                 # == hosts_per_tor -> full bisection
    dead_links: frozenset = frozenset()  # {(tor, spine), ...}

    def __post_init__(self):
        self.n_hosts = self.n_tor * self.hosts_per_tor
        # live uplinks per ToR (ECMP next-hop candidates)
        self.live_up = [
            [s for s in range(self.n_spine) if (t, s) not in self.dead_links]
            for t in range(self.n_tor)
        ]
        for t, ups in enumerate(self.live_up):
            if not ups:
                raise ValueError(f"ToR {t} has no live uplinks")

    @property
    def oversubscription(self) -> float:
        return self.hosts_per_tor / self.n_spine

    def tor_of(self, host: int) -> int:
        return host // self.hosts_per_tor

    def ecmp_spine(self, src: int, dst: int, entropy: int) -> int:
        """ECMP: hash (src, dst, entropy) onto a live uplink of src's ToR."""
        tor = self.tor_of(src)
        ups = self.live_up[tor]
        return ups[_mix(src, dst, entropy) % len(ups)]

    def same_tor(self, src: int, dst: int) -> bool:
        return self.tor_of(src) == self.tor_of(dst)


def full_bisection(n_tor: int, hosts_per_tor: int) -> FatTree:
    return FatTree(n_tor=n_tor, hosts_per_tor=hosts_per_tor,
                   n_spine=hosts_per_tor)


def oversubscribed(n_tor: int, hosts_per_tor: int, ratio: int) -> FatTree:
    assert hosts_per_tor % ratio == 0
    return FatTree(n_tor=n_tor, hosts_per_tor=hosts_per_tor,
                   n_spine=hosts_per_tor // ratio)


def with_link_failures(base: FatTree, n_failed: int, n_tors_affected: int,
                       seed: int = 0) -> FatTree:
    """Disable ``n_failed`` ToR-spine links spread over ``n_tors_affected``
    ToRs (paper: 16 ToRs, 64 or 256 links)."""
    import random
    rng = random.Random(seed)
    tors = rng.sample(range(base.n_tor), min(n_tors_affected, base.n_tor))
    per_tor = max(1, n_failed // max(1, len(tors)))
    dead = set()
    for t in tors:
        spines = rng.sample(range(base.n_spine),
                            min(per_tor, base.n_spine - 1))
        dead.update((t, s) for s in spines)
    return FatTree(n_tor=base.n_tor, hosts_per_tor=base.hosts_per_tor,
                   n_spine=base.n_spine, dead_links=frozenset(dead))
