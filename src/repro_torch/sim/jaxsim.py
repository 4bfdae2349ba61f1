"""Single-bottleneck incast: the 1-queue special case of ``fabric.py``.

The port of ``repro.sim.jaxsim`` (the module keeps its name so that a
reader finds its counterpart; it runs on PyTorch).  N STrack flows share
one egress queue, the paper's incast scenario (Figs. 16-20): a degenerate
fat-tree (one ToR, one spine, N+1 hosts) whose only contended queue is the
destination host's downlink, run on :func:`repro_torch.sim.fabric.run_fabric`
with a per-tick trace.  1 tick = 1 MTU serialization time at the
bottleneck:

  * each tick every flow may clock out <=1 packet (NIC rate == link rate),
  * the queue serves 1 packet/tick, marks egress ECN on residual depth
    between Kmin..Kmax, silently drops beyond 5 BDP,
  * SACKs ride the fixed-latency return pipe (forward delay folded in):
    the ``delay_ticks`` override keeps this module on the fabric's
    "folded" delay model.
"""
from __future__ import annotations

import dataclasses

from ..core.params import NetworkSpec
from .fabric import FabricConfig, run_fabric
from .topology import FatTree


@dataclasses.dataclass(frozen=True)
class IncastConfig:
    n_flows: int = 32
    msg_bytes: float = 2 * 2 ** 20
    net: NetworkSpec = dataclasses.field(default_factory=NetworkSpec)
    fwd_delay_ticks: int = 48     # sender->queue (~4us at 400G/4KB ticks)
    ret_delay_ticks: int = 48     # receiver->sender
    max_paths: int = 64


def run_incast(cfg: IncastConfig, n_ticks: int, device="cuda"):
    """(final state, per-tick metrics) of the incast on ``device``.

    ``metrics["queue_pkts"]`` is the bottleneck (destination downlink)
    occupancy per tick, and ``metrics["drops"]`` the per-tick cumulative
    drop trace (the single-queue simulator's keys)."""
    n = cfg.n_flows
    # all hosts on one ToR: every packet goes straight into the
    # destination host's downlink queue, the bottleneck
    topo = FatTree(n_tor=1, hosts_per_tor=n + 1, n_spine=1)
    flows = [(i + 1, 0, float(cfg.msg_bytes)) for i in range(n)]
    fcfg = FabricConfig(
        net=cfg.net, max_paths=cfg.max_paths,
        delay_ticks=cfg.fwd_delay_ticks + cfg.ret_delay_ticks)
    final, metrics = run_fabric(topo, flows, n_ticks, fcfg, device=device)
    bottleneck = metrics["queue_ids"]["host_down"](0)
    metrics["queue_pkts"] = metrics["qsize"][:, bottleneck]
    # "drops" is the per-tick cumulative trace here (the fabric reports
    # the final scalar under that key and the trace as "drops_trace")
    metrics["drops"] = metrics["drops_trace"]
    return final, metrics
