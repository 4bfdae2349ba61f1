"""The plain active transition against the reference's own kernel path,
and infer1024's generator at 8x8 under the cap, against the JAX
reference.

* JAX with ``kernel_backend="pallas_interpret"`` runs ``active_trans_core``
  inside ``fused_stage_kernel`` (``src/repro/kernels/fabric_kernels.py``)
  in interpret mode; on the arrival-gated trace of
  ``tests/test_torch_active.py`` at a cap of 5, under time warp, every
  ``FabricState`` leaf of the whole run equals the port's, STrack and
  RoCEv2 + PFC.
* infer1024's generator (four tenants, 16 KiB +- 50%, one arrival a tick
  each) with 128 messages a tenant on ``full_bisection(8, 8)``: 512 flows,
  at most 274 live at once, at a cap of 320 under STrack and RoCEv2 + PFC;
  the port's ``run`` equals JAX's on every summary key.
"""
import pytest

from repro.core.params import NetworkSpec as JNet
from repro.sim import fabric as JF
from repro.sim import traffic as JT
from repro.sim.topology import full_bisection as j_full_bisection
from repro.sim.workloads import Message as JMessage
from repro.sim.workloads import RunConfig as JRunConfig
from repro.sim.workloads import run as j_run

from repro_torch.core.params import NetworkSpec
from repro_torch.profile import INFER1024_TENANTS
from repro_torch.sim import fabric as TF
from repro_torch.sim import traffic as TT
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import Message, RunConfig, run

from torch_parity import arrival_trace, diff_leaves

pytestmark = [pytest.mark.tier1, pytest.mark.torch]


def _tenants(mod, **over):
    return [mod.InferenceTenant(f"inf{i}", **{**INFER1024_TENANTS, **over})
            for i in range(4)]


@pytest.mark.parametrize("proto", ["strack", "rocev2"])
def test_plain_active_transition_equals_the_reference_kernel_path(proto):
    """JAX with ``kernel_backend="pallas_interpret"`` steps the lanes in
    ``active_trans_core`` inside the Pallas kernel (interpret mode); the
    port's plain active transition gives the same state, leaf for leaf,
    after the whole warp run."""
    kw = dict(protocol=proto) if proto == "rocev2" else {}
    jfin, jm = JF.run_fabric_trace(
        j_full_bisection(2, 4), arrival_trace(JMessage), 9000,
        JF.FabricConfig(active_cap=5, time_warp=True,
                        kernel_backend="pallas_interpret", **kw))
    tfin, tm = TF.run_fabric_trace(
        full_bisection(2, 4), arrival_trace(Message), 9000,
        TF.FabricConfig(active_cap=5, time_warp=True, **kw), device="cpu")
    bad = diff_leaves(jfin, tfin, ring_rows=3 * 8)
    assert not bad, bad[:5]
    assert int(jm["warp_trips"]) == tm["warp_trips"]


def test_infer_generator_at_8x8_equals_jax():
    """infer1024's generator (four tenants, 16 KiB +- 50%, one arrival a
    tick) with 128 messages a tenant on ``full_bisection(8, 8)``, at a cap
    below N under STrack and RoCEv2 + PFC: the port's ``run`` equals
    JAX's on every summary key."""
    over = dict(n_flows=128)
    jsc, _ = JT.mixed_scenario(j_full_bisection(8, 8), (),
                               _tenants(JT, **over),
                               net=JNet(link_gbps=400.0), seed=0)
    tsc, _ = TT.mixed_scenario(full_bisection(8, 8), (),
                               _tenants(TT, **over),
                               net=NetworkSpec(link_gbps=400.0), seed=0)
    for kw in (dict(active_cap=320),
               dict(protocol="rocev2", active_cap=320)):
        want = j_run(jsc, JRunConfig(**kw))
        got = run(tsc, RunConfig(**kw), device="cpu")
        for k in want:
            assert got[k] == want[k], (kw, k)
        assert got["unfinished"] == 0 and got["total_groups"] == 4


def _c_fields(text: str, name: str) -> list:
    """Field names of ``struct name`` in a CUDA source, in order (an
    array's name without its extent)."""
    import re
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    out = []
    for decl in re.sub(r"//.*", "", body).split(";"):
        decl = re.sub(r"\[[^]]*\]", "", decl)
        words = decl.replace("*", " ").replace(",", " , ").split()
        words = [w for w in words if w != "const"]
        n_type = 2 if words[:1] in (["long"], ["unsigned"]) and words[1] in (
            "long", "int", "char", "short") else 1      # long long, ...
        out += [w for w in words[n_type:] if w != ","]  # drop the type
    return out


def test_kernel_structs_match_their_ctypes_bindings():
    """Every parameter and pointer struct of the fabric kernels' C entry
    points lists the same fields in the same order as its ctypes mirror in
    ``kernels/_cuda_bind.py`` (a field out of place passes one pointer for
    another, which no CPU run would show); so does flash attention's
    ``FaArgs`` (every route's arguments, the decode split's scratch and
    counters among them) its mirror in ``kernels/flash_attention.py``, and
    the SSD scan's ``SsdArgs`` and ``SsdBwdArgs`` (their launches' scratch
    among them) their mirrors in ``kernels/ssd_scan.py``; and the serve
    kernel's bucket slots, the PFC warp's counters and the STrack
    transition's block of warps (the source index's flows a block) their
    Python mirrors."""
    from pathlib import Path
    from repro_torch.kernels import _cuda_bind as B
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    csrc = Path(B.__file__).parent / "csrc"
    pairs = {"transition": [("TransParams", B.TransParams),
                            ("TransOut", B.TransOut),
                            ("FlowPtrs", B.FlowPtrs),
                            ("SackPtrs", B.SackPtrs),
                            ("TxPtrs", B.TxPtrs)],
             "transition_roce": [("RoceParams", B.RoceParams),
                                 ("RoceOut", B.TransOut),
                                 ("RoceFlowPtrs", B.RoceFlowPtrs),
                                 ("RoceMsgPtrs", B.RoceMsgPtrs)],
             "serve_enqueue": [("ServeParams", B.ServeParams),
                               ("Ring", B.Ring), ("ServeIn", B.ServeIn),
                               ("ServeOut", B.ServeOut),
                               ("ServeScratch", B.ServeScratch),
                               ("PfcParams", B.PfcParams),
                               ("PfcIn", B.PfcIn), ("PfcState", B.PfcPtrs)],
             "flash_attention": [("FaArgs", fa.FaArgs)],
             "ssd_scan": [("SsdArgs", ssd.SsdArgs),
                          ("SsdBwdArgs", ssd.SsdBwdArgs)]}
    for source, structs in pairs.items():
        text = (csrc / f"{source}.cu").read_text()
        for name, cls in structs:
            assert _c_fields(text, name) == [f[0] for f in cls._fields_], \
                (source, name)
    # the serve kernel's fixed bucket slots, which the wrapper's scratch
    # allocation counts, and the PFC warp's counters, which it checks
    import re
    text = (csrc / "serve_enqueue.cu").read_text()
    const = lambda n: int(re.search(r"constexpr int %s = (\d+);" % n,
                                     text).group(1))
    assert const("kBucket") == B.BUCKET
    assert 32 * const("kRows") == B.PFC_WARP_COUNTERS
    from repro_torch.kernels.fabric_kernels import BLOCK_FLOWS
    text = (csrc / "transition.cu").read_text()
    assert const("kWarps") == BLOCK_FLOWS
