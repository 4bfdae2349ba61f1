"""The PFC gates' thresholds against the JAX reference on fractional tails
(ROADMAP C14's open check, settled as C16).

Each switch's dynamic threshold ``xoff = a * max(buffer - occ, 0) / (1 +
a)`` rests on its occupancy, a row sum of the queue bytes.  Inside the
reference's jitted tick XLA sums a row of n floats in chunks of the
largest divisor of n up to 32, each from zero left to right, then the
chunks left to right; ``torch.sum`` sums in another order, which
fractional tails show in the last bit.  The port sums as XLA does
(``kernels.fabric_kernels.row_sums``).  The test records every threshold
the gates of both packages see, tick by tick, on small-buffer STrack +
PFC incasts whose messages end in fractional tails, near the gates'
thresholds (the switches fill to their buffer), at row lengths 16, 48 and
64.
"""
import numpy as np
import pytest
import torch

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import incast_scenario as j_incast

from repro_torch.core.params import NetworkSpec
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.numerics import f32, recip32
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection

from torch_parity import diff_leaves

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

#: (ToRs, hosts a ToR = spines, senders): rows of 16, 48 and 64 bytes
#: counters, each summed in chunks of 16, 24 and 32
SHAPES = [(8, 16, 32), (4, 48, 48), (4, 64, 64)]
MSG_BYTES = 3 * 4096 - 0.7     # a fractional tail
BUFFER = 2e5
TICKS = 200


def _record(monkeypatch, module, into, convert):
    """Record the threshold each call of ``module.pfc_gate`` is given."""
    orig = module.pfc_gate

    def gate(paused, ingress, xoff, xon_frac):
        convert(into, xoff)
        return orig(paused, ingress, xoff, xon_frac)

    monkeypatch.setattr(module, "pfc_gate", gate)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pfc_thresholds_equal_jax_on_fractional_tails(monkeypatch, shape):
    import jax
    tors, hpt, senders = shape
    jnet = JNet(link_gbps=400.0)
    jsc = j_incast(j_full_bisection(tors, hpt), senders, MSG_BYTES, net=jnet)
    kw = dict(pfc=True, switch_buffer_bytes=BUFFER, time_warp=False,
              trace_every=0)
    j_xoff, t_xoff, t_qbytes = [], [], []
    _record(monkeypatch, JF, j_xoff, lambda into, x: jax.debug.callback(
        lambda v: into.append(np.array(v)), x, ordered=True))
    _record(monkeypatch, fk, t_xoff,
            lambda into, x: into.append(x.clone().numpy()))
    plain = fk.pfc_account_plain

    def account(*args, **kwargs):
        out = plain(*args, **kwargs)
        t_qbytes.append(out.qbytes.clone())
        return out

    monkeypatch.setattr(fk, "pfc_account_plain", account)
    JF.clear_program_cache()   # trace the reference anew, with the probe
    try:
        jfin, _ = JF.run_fabric_trace(jsc.topo, jsc.messages, TICKS,
                                      JF.FabricConfig(net=jnet, **kw))
        jax.effects_barrier()
    finally:
        JF.clear_program_cache()
    topo = full_bisection(tors, hpt)
    cfg = TF.FabricConfig(net=NetworkSpec(link_gbps=400.0), **kw)
    tfin, _ = TF.run_fabric_trace(topo, jsc.messages, TICKS, cfg,
                                  device="cpu")

    # three gates a tick (NICs, spine downlinks, ToR uplinks)
    assert len(j_xoff) == len(t_xoff) == 3 * TICKS
    for i, (a, b) in enumerate(zip(j_xoff, t_xoff)):
        assert a.shape == b.shape and (a.view(np.int32)
                                       == b.view(np.int32)).all(), (
            f"tick {i // 3}, gate {i % 3}: thresholds differ")
    assert not diff_leaves(jfin, tfin, ring_rows=2 * topo.n_tor
                           * topo.n_spine + topo.n_hosts)
    assert int(tfin.pauses) > 0

    # the run is near the thresholds with fractional bytes, where the sum
    # order shows: torch.sum's occupancies give other ToR thresholds
    T, S, H = topo.n_tor, topo.n_spine, topo.hosts_per_tor
    TS = T * S
    a, inv = f32(cfg.pfc_alpha), recip32(1 + cfg.pfc_alpha)
    buf = f32(BUFFER)
    shown = 0
    for tick, qb in enumerate(t_qbytes):
        occ = qb[:TS].reshape(T, S).sum(1) + qb[2 * TS:-1].reshape(T, H).sum(1)
        other = (a * torch.clamp_min(buf - occ, 0.0) * inv).numpy()
        mine = t_xoff[3 * tick][::H]   # xoff_tor[host_tor]: a ToR's hosts
        shown += int((other.view(np.int32) != mine.view(np.int32)).any())
    assert shown > 0


@pytest.mark.parametrize("n,chunk", [(1, 1), (4, 4), (8, 8), (16, 16),
                                     (32, 32), (37, 1), (40, 20), (48, 24),
                                     (64, 32), (96, 32), (128, 32)])
def test_row_chunk(n, chunk):
    assert fk.row_chunk(n) == chunk


@pytest.mark.parametrize("n", [4, 16, 32, 48, 64, 128])
def test_row_sums_follow_the_chunked_order(n):
    """``row_sums`` against a scalar numpy model of the chunked order, on
    fractional rows whose sums round."""
    rng = np.random.default_rng(n)
    x = (rng.integers(0, 40, (50, n)) * 4096.0
         + rng.random((50, n)) * 4096.0).astype(np.float32)
    c = fk.row_chunk(n)
    want = np.zeros(50, np.float32)
    for r in range(50):
        total = np.float32(0)
        for k in range(0, n, c):
            part = np.float32(0)
            for j in range(k, k + c):
                part = np.float32(part + x[r, j])
            total = np.float32(total + part)
        want[r] = total
    got = fk.row_sums(torch.from_numpy(x)).numpy()
    assert (got.view(np.int32) == want.view(np.int32)).all()
