"""The port's three fabric kernels, through their plain PyTorch versions.

On the CPU each wrapper runs its kernel's plain version, so here the
plain versions are held against the JAX reference: the ranker against
``rank_in_queue_core`` / ``fabric._rank_in_queue`` at the chunk
boundaries, and the transition and serve/enqueue stages through
whole-state equality of every ``FabricState`` leaf after k dense ticks
against ``repro.sim.fabric.run_fabric_trace``, on a 4x4 permutation
(M = 64 enqueue candidates: the reference's all-pairs rank) and an 8x16
one (128 hosts, M = 512: the chunked ranker in both packages).  The CUDA
kernels themselves run on the card only: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold each kernel against its plain version there.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.params import NetworkSpec as JNet
from repro.kernels.fabric_kernels import (rank_in_queue_core,
                                          rank_in_queue_kernel)
from repro.sim import fabric as JF
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import permutation_scenario as j_permutation

from repro_torch.core.params import NetworkSpec
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection

from torch_parity import diff_leaves

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

SIZES = [255, 256, 257, 511, 512, 513]


def _rank_cases(m, seed):
    rng = np.random.default_rng(seed)
    yield rng.integers(0, 40, m), rng.random(m) < 0.5        # mixed
    yield rng.integers(0, 3, m), np.ones(m, bool)             # all, dup-heavy
    yield rng.integers(0, 40, m), np.zeros(m, bool)           # none flagged
    yield np.zeros(m, np.int64), rng.random(m) < 0.9          # one queue


@pytest.mark.parametrize("m", SIZES)
def test_ranker_plain_matches_jax_cores(m):
    for qid, flag in _rank_cases(m, m):
        qid = qid.astype(np.int32)
        want = np.asarray(rank_in_queue_core(jnp.asarray(qid),
                                             jnp.asarray(flag), 40))
        want2 = np.asarray(JF._rank_in_queue(jnp.asarray(qid),
                                              jnp.asarray(flag), 40))
        got = fk.rank_in_queue(torch.from_numpy(qid),
                               torch.from_numpy(flag), 40).numpy()
        assert np.array_equal(want, got) and np.array_equal(want2, got)


def test_ranker_plain_matches_pallas_interpret_and_empty():
    rng = np.random.default_rng(7)
    qid = rng.integers(0, 9, 300).astype(np.int32)
    flag = rng.random(300) < 0.6
    want = np.asarray(rank_in_queue_kernel(jnp.asarray(qid),
                                           jnp.asarray(flag), 9,
                                           interpret=True))
    got = fk.rank_in_queue(torch.from_numpy(qid), torch.from_numpy(flag),
                           9).numpy()
    assert np.array_equal(want, got)
    empty = fk.rank_in_queue(torch.zeros(0, dtype=torch.int32),
                             torch.zeros(0, dtype=torch.bool), 4)
    assert empty.shape == (0,) and empty.dtype == torch.int32


@pytest.mark.parametrize("m", [64, 256])
def test_ranker_equals_reference_all_pairs_where_flagged(m):
    """Up to 256 candidates the reference ranks with an all-pairs count
    (``fabric.py:1283-1291``); the port always runs the ranker, which gives
    the same rank wherever the flag is set (the only entries read)."""
    rng = np.random.default_rng(m)
    qid = rng.integers(0, 11, m).astype(np.int32)
    flag = rng.random(m) < 0.5
    jq, jf = jnp.asarray(qid), jnp.asarray(flag)
    tril = jnp.arange(m)[None, :] < jnp.arange(m)[:, None]
    want = np.asarray(jnp.sum((jq[:, None] == jq[None, :]) & jf[None, :]
                              & tril, axis=1).astype(jnp.int32))
    got = fk.rank_in_queue(torch.from_numpy(qid), torch.from_numpy(flag),
                           11).numpy()
    assert np.array_equal(want[flag], got[flag])
    assert np.all(got[~flag] == -1)


def test_wrappers_dispatch_by_device_without_counting_cpu_calls():
    fk.reset_launches()
    qid = torch.zeros(4, dtype=torch.int32)
    fk.rank_in_queue(qid, torch.ones(4, dtype=torch.bool), 2)
    assert fk.launches == {"flow_transition": 0, "flow_transition_roce": 0,
                           "flow_transition_active": 0,
                           "flow_transition_roce_active": 0,
                           "serve_enqueue": 0, "rank_in_queue": 0,
                           "pfc_account": 0, "flow_transition_batch": 0,
                           "flow_transition_roce_batch": 0,
                           "serve_enqueue_batch": 0, "pfc_account_batch": 0}
    with pytest.raises(ValueError, match="no kernel"):
        fk.rank_in_queue(qid.to("meta"), torch.ones(4, dtype=torch.bool,
                                                    device="meta"), 2)
    with pytest.raises(TypeError):
        fk.rank_in_queue(qid.long(), torch.ones(4, dtype=torch.bool), 2)


@pytest.mark.parametrize("T,H,size,M", [(4, 4, 256 * 2 ** 10, 64),
                                        (8, 16, 64 * 2 ** 10, 512)])
@pytest.mark.parametrize("k", [1, 2, 8, 40, 200])
def test_dense_ticks_whole_state_equals_jax(T, H, size, M, k):
    """Every FabricState leaf after k dense ticks, port vs reference (the
    ring's trash row aside: its contents are never read)."""
    jsc = j_permutation(j_full_bisection(T, H), size,
                        net=JNet(link_gbps=400.0), seed=0)
    jfin, _ = JF.run_fabric_trace(
        jsc.topo, jsc.messages, k,
        JF.FabricConfig(net=jsc.net, time_warp=False, trace_every=0))
    cfg = TF.FabricConfig(net=NetworkSpec(link_gbps=400.0),
                          time_warp=False, trace_every=0)
    prog_m = 2 * T * H + 2 * T * H
    assert prog_m == M
    tfin, _ = TF.run_fabric_trace(full_bisection(T, H), jsc.messages, k,
                                  cfg, device="cpu")
    q_rows = 2 * T * H + T * H
    bad = diff_leaves(jfin, tfin, ring_rows=q_rows)
    assert not bad, f"first diverging leaves after {k} ticks: {bad[:5]}"
