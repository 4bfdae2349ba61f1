"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Skips without a CUDA device (and imports no JAX, so it also runs on the
card's machine): ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  ``chip_smoke.py`` runs the same checks at the
full perm1024 / perm8k shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.params import NetworkSpec
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import permutation_scenario

pytestmark = [pytest.mark.torch, pytest.mark.cuda]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [255, 256, 257, 511, 512, 513, 4096, 32768])
def test_ranker_kernel_matches_plain(cuda, m):
    rng = np.random.default_rng(m)
    for span, density in ((97, 0.5), (3, 1.0), (7, 0.0)):
        qid = torch.from_numpy(rng.integers(0, span, m).astype(np.int32))
        flag = torch.from_numpy(rng.random(m) < density)
        qid, flag = qid.to(cuda), flag.to(cuda)
        assert torch.equal(fk.rank_in_queue(qid, flag, 97),
                           fk.rank_in_queue_plain(qid, flag, 97))


def test_fabric_on_the_card_equals_the_cpu(cuda):
    sc = permutation_scenario(full_bisection(8, 16), 64 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = TF.FabricConfig(net=sc.net, time_warp=True, trace_every=0)
    fk.reset_launches()
    _, m_gpu = TF.run_fabric_trace(sc.topo, sc.messages, 2000, cfg,
                                   device=cuda)
    assert all(n > 0 for n in fk.launches.values()), fk.launches
    _, m_cpu = TF.run_fabric_trace(sc.topo, sc.messages, 2000, cfg,
                                   device="cpu")
    np.testing.assert_array_equal(m_gpu["done_tick"], m_cpu["done_tick"])
    assert m_gpu["warp_trips"] == m_cpu["warp_trips"]
    assert m_gpu["ecn_marks"] == m_cpu["ecn_marks"]
