"""The program's source index (the flows grouped by source NIC) that the
transition kernels arbitrate by, on the CPU.

``kernels.fabric_kernels.src_index`` against numpy's stable argsort and
offsets on perm1024, incast1024, infer1024 and random sources with empty
hosts; its blocks (whole sources, at most ``BLOCK_FLOWS`` flows, or one
source with more); the program building it once and passing it to the
transition on every protocol and path; and the plain transitions, which
do not read it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.params import NetworkSpec
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.sim import fabric as TF
from repro_torch.sim.faults import FaultSpec
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import incast_scenario, permutation_scenario

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

NET = NetworkSpec(link_gbps=400.0)


def _srcs(name):
    """(src, n_hosts) of a named layout."""
    rng = np.random.default_rng(len(name))
    if name == "perm1024":
        sc = permutation_scenario(full_bisection(32, 32), 64 * 2 ** 10,
                                  net=NET, seed=0)
    elif name == "incast1024":
        sc = incast_scenario(full_bisection(32, 32), 256, 16 * 2 ** 10,
                             net=NET)
    elif name == "infer1024":
        from repro_torch.profile import infer1024_scenario
        sc = infer1024_scenario()
    elif name == "random_empty_hosts":
        hosts = np.sort(rng.choice(1024, 200, replace=False))
        return hosts[rng.integers(0, 200, 3000)], 1024
    elif name == "one_source":
        return np.full(1024, 5), 1024
    else:   # a few large sources between small ones
        sizes = rng.choice([1, 2, 40, 3, 17], 300)
        return np.repeat(rng.permutation(300), sizes), 300
    return np.array([m.src for m in sc.messages]), sc.topo.n_hosts


LAYOUTS = ["perm1024", "incast1024", "infer1024", "random_empty_hosts",
           "one_source", "mixed_large"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_src_index_equals_numpy_stable_argsort(name):
    src, nh = _srcs(name)
    index = fk.src_index(torch.from_numpy(src.astype(np.int32)), nh)
    assert all(x.dtype == torch.int32 for x in index)
    np.testing.assert_array_equal(index.by_src.numpy(),
                                  np.argsort(src, kind="stable"))
    np.testing.assert_array_equal(index.src_sorted.numpy(), np.sort(src))
    start = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=nh))])
    np.testing.assert_array_equal(index.src_start.numpy(), start)


@pytest.mark.parametrize("name", LAYOUTS)
def test_src_index_blocks_hold_whole_sources(name):
    """Each block of the transitions is a run of whole sources of at most
    BLOCK_FLOWS flows, or one source with more; the blocks cover every
    flow once, and packing is greedy (a block and the next source's flows
    together exceed BLOCK_FLOWS)."""
    src, nh = _srcs(name)
    index = fk.src_index(torch.from_numpy(src.astype(np.int32)), nh)
    blocks = index.blocks.numpy()
    start = index.src_start.numpy()
    by = index.by_src.numpy()
    assert blocks[0] == 0 and blocks[-1] == len(src)
    assert (np.diff(blocks) > 0).all()
    assert set(blocks.tolist()) <= set(start.tolist())
    for b0, b1 in zip(blocks[:-1], blocks[1:]):
        n_src = len(set(src[by[b0:b1]].tolist()))
        assert b1 - b0 <= fk.BLOCK_FLOWS or n_src == 1, (b0, b1)
    for b0, b1 in zip(blocks[:-2], blocks[1:-1]):
        nxt = src[by[b1]]
        assert (b1 - b0) + (start[nxt + 1] - start[nxt]) > fk.BLOCK_FLOWS
    if name == "infer1024":
        assert (np.diff(blocks) <= fk.BLOCK_FLOWS).all()   # never walked twice
    if name == "one_source":
        assert blocks.tolist() == [0, 1024]


@pytest.mark.parametrize("counts,want", [
    ([1] * 40, [0, 16, 32, 40]),
    ([0, 3, 0, 0, 20, 2, 15, 1], [0, 3, 23, 25, 41]),
    ([17], [0, 17]),
    ([16, 16, 0], [0, 16, 32]),
    ([0, 0], [0]),
])
def test_blocks_pack_sources_greedily(counts, want):
    assert fk._blocks(counts, 16) == want


def _program(protocol, pfc=None, active_cap=None, faults=None):
    from repro_torch.sim.traffic import InferenceTenant, mixed_scenario
    from torch_parity import OPEN_LOOP_TENANTS
    if active_cap:
        sc, _ = mixed_scenario(full_bisection(4, 4), (),
                               [InferenceTenant(**t)
                                for t in OPEN_LOOP_TENANTS], net=NET, seed=0)
    else:
        sc = incast_scenario(full_bisection(4, 4), 8, 64 * 2 ** 10, net=NET)
    kw = dict(protocol=protocol, active_cap=active_cap, faults=faults)
    if pfc is not None:
        kw["pfc"] = pfc
    cfg = TF.FabricConfig(net=sc.net, trace_every=0, **kw)
    return TF.trace_program(sc.topo, sc.messages, 400, cfg, "cpu")


PATHS = {"dense": {}, "pfc": dict(pfc=True), "lossy": dict(pfc=False),
         "faults": dict(faults=FaultSpec(link_flaps=((0, 0, 10, 60),),
                                         seed=3)),
         "active": dict(active_cap=24)}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_program_passes_its_src_index_to_the_transition(protocol, path):
    """The program builds the index once at bind, shares its by_src and
    src_start with the PFC stage, and ``transport_args`` hands it to the
    transition last, on the dense and active paths alike; the transition
    the tick runs gets it too."""
    prog = _program(protocol, **PATHS[path])
    index = prog.src_index
    want = fk.src_index(prog.src, prog.NH)
    for a, b in zip(index, want):
        assert torch.equal(a, b)
    if prog.pfc:
        assert prog.pfc_flows.by_src is index.by_src
        assert prog.pfc_flows.src_start is index.src_start
    st = prog.init_state()
    seen = []
    name = "flow_transition_active" if prog.A else "flow_transition"
    real = getattr(TF, name)

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    for t in range(12):
        lanes = None
        if prog.A:
            mask = (prog.sendable_msg(st, t)[prog.dep.msg_of_flow.long()]
                    & ~prog.proto.done(st.flows))
            lanes, _ = prog.lane_slate(mask)
        eff_nic, _ = prog.eff_pause(st, t)
        targs = prog.transport_args(st, t, prog.sendable_msg(st, t),
                                    eff_nic, lanes)
        assert targs[-1] is index and len(targs) == 8
        setattr(TF, name, spy)
        try:
            st, _, _ = prog.tick(st, t)
        finally:
            setattr(TF, name, real)
    assert len(seen) == 12 and all(x is index for x in seen)


@pytest.mark.parametrize("protocol", ["strack", "rocev2"])
def test_plain_transition_does_not_read_the_index(protocol):
    """The plain transitions keep their scatter_reduce: the same outputs
    with the program's index, with an index of another layout, or none."""
    prog = _program(protocol, pfc=True)
    other = fk.src_index(torch.zeros_like(prog.src), prog.NH)
    st = prog.init_state()
    won = 0
    for t in range(40):
        targs = prog.transport_args(st, t, prog.sendable_msg(st, t),
                                    prog.eff_pause(st, t)[0])
        outs = [fk.flow_transition(*targs[:-1], idx) for idx in
                (targs[-1], other, None)]
        for out in outs[1:]:
            for a, b in zip(fk._tree_leaves(outs[0]), fk._tree_leaves(out)):
                assert torch.equal(a, b)
        won += int(outs[0][4].sum())
        st, _, _ = prog.tick(st, t)
    assert won > 0


def test_kernel_dispatch_needs_the_index():
    """On CUDA tensors the transitions launch their kernel over the index
    or raise; the check names the index (run here on its own: there is no
    card)."""
    with pytest.raises(ValueError, match="SrcIndex"):
        fk._check_index(None, 4, torch.device("cpu"))
    index = fk.src_index(torch.tensor([0, 1, 1, 3], dtype=torch.int32), 4)
    fk._check_index(index, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="index.by_src"):
        fk._check_index(index, 5, torch.device("cpu"))
