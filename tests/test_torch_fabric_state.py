"""The port's fabric state against the JAX reference under the options
the port honours, and the ECN dither over every tick and row the tests
visit.

Every ``FabricState`` leaf after k dense ticks: the incast's standing
queue (ECN marks decided by the dither on most ticks), oblivious and
fixed spray, and the folded ACK path (4x4 fabric).  The dither is held
bit for bit against the reference's expression evaluated as its fabric
program does.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import incast_scenario as j_incast
from repro.sim.workloads import permutation_scenario as j_permutation

from repro_torch.core.params import NetworkSpec
from repro_torch.numerics import ecn_dither
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import (RunConfig, _scenario_ticks,
                                       incast_scenario, permutation_scenario)

from torch_parity import diff_leaves

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

NET400 = NetworkSpec(link_gbps=400.0)
TOPO44 = full_bisection(4, 4)


@pytest.mark.parametrize("case,k,kw", [
    ("incast8", 300, {}),
    ("perm16", 60, {"lb_mode": "oblivious"}),
    ("perm16", 60, {"lb_mode": "fixed"}),
    ("perm16", 60, {"ack_path": "folded"}),
])
def test_fabric_options_whole_state_equals_jax(case, k, kw):
    """Every FabricState leaf after k dense ticks under the incast's
    standing queue (ECN marks decided by the dither on most ticks) and the
    other spray modes and ACK path the port honours."""
    jnet = JNet(link_gbps=400.0)
    if case == "incast8":
        jsc = j_incast(j_full_bisection(4, 4), 8, 512 * 2 ** 10, net=jnet)
    else:
        jsc = j_permutation(j_full_bisection(4, 4), 256 * 2 ** 10, net=jnet,
                            seed=0)
    jfin, _ = JF.run_fabric_trace(
        jsc.topo, jsc.messages, k,
        JF.FabricConfig(net=jnet, time_warp=False, trace_every=0, **kw))
    tfin, _ = TF.run_fabric_trace(
        TOPO44, jsc.messages, k,
        TF.FabricConfig(net=NET400, time_warp=False, trace_every=0, **kw),
        device="cpu")
    bad = diff_leaves(jfin, tfin, ring_rows=3 * 16)
    assert not bad, f"first diverging leaves after {k} ticks: {bad[:5]}"
    if case == "incast8":
        assert int(tfin.ecn_marks) > 100


def _dither_grids():
    """(n_ticks, n_queue_rows) of every fabric run in the port's tests."""
    perm16 = permutation_scenario(TOPO44, 256 * 2 ** 10, net=NET400, seed=0)
    incast8 = incast_scenario(TOPO44, 8, 512 * 2 ** 10, net=NET400)
    perm1024 = permutation_scenario(full_bisection(32, 32), 64 * 2 ** 10,
                                    net=NET400, seed=0)
    incast1024 = incast_scenario(full_bisection(32, 32), 256, 16 * 2 ** 10,
                                 net=NET400)
    return {"perm16": (perm16.default_ticks(), 48),
            "incast8": (incast8.default_ticks(), 48),
            "perm_8x16": (200, 3 * 128),
            "perm1024": (_scenario_ticks(perm1024, RunConfig()), 3072),
            "incast1024": (_scenario_ticks(incast1024, RunConfig()), 3072)}


def test_ecn_dither_equals_jax_on_every_tested_tick_and_row():
    """The reference's dither expression, evaluated as its fabric program
    does (a scalar tick against the precomputed row products, inside a
    loop over ticks), against the port's over every tick and row, bit for
    bit."""
    def dither(t, rows):
        return jnp.abs(jnp.sin(t.astype(jnp.float32) * 12.9898
                               + rows.astype(jnp.float32) * 78.233))

    chunk = 1024   # ticks per comparison, to bound the memory
    for name, (n_ticks, q) in _dither_grids().items():
        rows = jnp.arange(q, dtype=jnp.int32)
        grid = jax.jit(lambda ts: jax.lax.map(lambda t: dither(t, rows), ts))
        for t0 in range(0, n_ticks, chunk):
            t1 = min(t0 + chunk, n_ticks)
            want = np.asarray(grid(jnp.arange(t0, t1, dtype=jnp.int32))
                              ).view(np.int32)
            got = ecn_dither(
                torch.arange(t0, t1, dtype=torch.int32)[:, None],
                torch.arange(q, dtype=torch.int32)[None, :])
            bad = np.argwhere(want != got.numpy().view(np.int32))
            assert not len(bad), (name, t0, bad[:5])
        t = n_ticks - 1
        assert torch.equal(ecn_dither(t, torch.arange(q, dtype=torch.int32)),
                           got[-1])
