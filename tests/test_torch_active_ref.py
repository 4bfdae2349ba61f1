"""infer1024 under the active set: the committed JAX-made reference files.

``infer1024`` (``repro_torch.profile.infer1024_scenario``: four open-loop
inference tenants of ``traffic.mixed_scenario``, 4096 flows of 16 KiB +-
50% on ``full_bisection(32, 32)`` at 400 Gbps, seed 0) at
``active_cap=512`` under STrack and under RoCEv2 + PFC.  Each file is
rebuilt from the JAX package and must equal the committed one; the STrack
file also holds the uncapped run, which equals the capped one on every
key, and the tick count of the run at a cap of 320, which raises.  The
port's full-width runs (1573 and 1565 warp trips) are held against these
files on the card only (``chip_smoke.py``, phase 6d): on the CPU they
would cost minutes of every test run; ``tests/test_torch_active_kernels.py``
runs the generator at 8x8 against JAX instead.
"""
import json

import pytest

from torch_parity import (INFER_REF_PATHS, INFER_REFS, INFER_SUMMARY_KEYS,
                          infer_reference)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]


@pytest.mark.parametrize("name", sorted(INFER_REFS))
def test_infer_reference_file_is_what_jax_computes(name):
    ref = json.loads(INFER_REF_PATHS[name].read_text())
    assert ref == infer_reference(name)
    assert ref["unfinished"] == 0 and ref["total_groups"] == 4
    assert ref["drops"] == 0 and ref["pauses"] == 0
    if name == "infer1024_strack_cap512":
        assert (ref["max_fct"], ref["ecn_marks"], ref["retransmits"],
                ref["warp_trips"]) == (10.48576, 3, 14, 1573)
        un = ref["uncapped"]
        for k in INFER_SUMMARY_KEYS + ("warp_trips", "end_tick",
                                       "done_tick"):
            assert un[k] == ref[k], k
        assert (ref["small_cap"], ref["small_cap_overflow_ticks"]) == (320,
                                                                        95)
    else:
        assert (round(ref["max_fct"], 9), ref["warp_trips"]) == (9.99424, 1565)
