"""The committed JAX-made reference files of the full-width collectives.

* ``hd1024_strack``: ``hd1024`` (``repro_torch.profile.COLLECTIVE1024``:
  eight HD allreduces of 128 ranks and 128 KiB, allreduce8k's job shape,
  on ``full_bisection(32, 32)`` at 400 Gbps, seed 0: 14,336 messages,
  13,312 dependency edges, 14 flows a source) under STrack;
* ``hd1024_roce4``: the same trace under ``RunConfig(protocol="rocev2",
  subflows=4)``, the paper's tuned 4-QP RoCEv2: 57,344 stripes, 56 to a
  source, so the RoCEv2 transition's block walks a source of more than 16
  flows;
* ``a2a1024_strack``: ``a2a1024`` (32 all-to-alls of 32 ranks and 512 KiB
  with window 8: 31,744 messages, 23,552 edges, 31 flows a source,
  windowed incasts on the receivers) under STrack.

The files were made by the JAX package (``python tests/torch_parity.py
<stem>``: two to three minutes each on a CPU, too long for every test
run).  Each test checks that its file was made from the trace both
packages generate (the message lists' digest, message and edge counts)
and is whole.  The port's runs are held against the files on the card
only (``chip_smoke.py``, phase 6e; hd1024 also at ``active_cap=1024``,
HD chains each rank's sends so at most 1024 messages are live): on the
CPU the port takes ~60 ms a tick at 1024 hosts.
"""
import pytest

from torch_parity import committed_collective_file

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

#: stem -> (messages, flows, warp trips, end tick, max_collective_time,
#: groups) of the JAX run
EXPECTED = {
    "hd1024_strack": (14336, 14336, 1495, 9834, 120.75008, 8),
    "hd1024_roce4": (14336, 57344, 1500, 9834, 123.78112, 8),
    "a2a1024_strack": (31744, 31744, 575, 5664, 40.22272, 32),
}


@pytest.mark.parametrize("stem", sorted(EXPECTED))
def test_collective_file_matches_its_trace(stem):
    ref = committed_collective_file(stem)
    msgs, flows, trips, end, mct, groups = EXPECTED[stem]
    assert (ref["n_msgs"], ref["n_flows"]) == (msgs, flows)
    assert (ref["warp_trips"], ref["end_tick"]) == (trips, end)
    assert round(ref["max_collective_time"], 6) == mct
    assert ref["total_groups"] == groups and ref["drops"] == 0
