"""Where a run's time goes on the GPU: a fabric scenario or a serve cell.

    PYTHONPATH=src python -m repro_torch.profile [--scenario perm1024]
    PYTHONPATH=src python -m repro_torch.profile --scenario perm1024-rocev2 \
        incast1024-rocev2
    PYTHONPATH=src python -m repro_torch.profile --scenario \
        perm1024-chaos-strack perm1024-chaos-rocev2
    PYTHONPATH=src python -m repro_torch.profile --scenario \
        infer1024-strack infer1024-strack-dense infer1024-rocev2
    PYTHONPATH=src python -m repro_torch.profile --scenario hd1024 \
        hd1024-roce4 a2a1024
    PYTHONPATH=src python -m repro_torch.profile --scenario prefill-1000 \
        prefill-4096 decode-544
    PYTHONPATH=src python -m repro_torch.profile --scenario \
        mamba2-prefill-1024 mamba2-prefill-4096 mamba2-decode \
        zamba2-prefill-1024 zamba2-decode
    PYTHONPATH=src python -m repro_torch.profile --scenario \
        whisper-prefill-448 whisper-decode internvl2-prefill-1024 \
        internvl2-decode
    PYTHONPATH=src python -m repro_torch.profile --scenario mamba2-train \
        llama3-train

Runs each scenario on the card twice (the first run warms up: it builds
the kernels and PyTorch's caches) and profiles the second with
``torch.profiler``: wall time, the device-busy share (summed kernel time
over wall time), the hand-written kernels' device time, and device time by
kernel for the 25 largest (with their launches).  Fabric scenarios run
through ``run_fabric_trace`` and also report wall and device-busy time per
warp trip: perm1024 and perm8k (STrack), perm1024-rocev2 and
incast1024-rocev2 (RoCEv2 with PFC; incast1024 is 256 senders of 16 KiB
to host 0 on the perm1024 fabric), perm1024-chaos-strack and
perm1024-chaos-rocev2 (perm1024 under the ``CHAOS1024`` fault schedule,
STrack over lossy queues and RoCEv2 over PFC), infer1024-strack and
infer1024-rocev2 (four open-loop inference tenants, 4096 flows, under the
active set at ``active_cap=512``) and infer1024-strack-dense (the same
uncapped), hd1024 and a2a1024 (the ``COLLECTIVE1024`` collectives under
STrack) and hd1024-roce4 (hd1024 under RoCEv2 + PFC striped over four
sub-flows, the paper's 4-QP RoCEv2); serve cells run a model in bf16 with
``attn_impl="pallas"`` and random weights from seed 0 (one model on the
card at a time): llama3-8b ``prefill-1000`` (4 x 1000 tokens),
``prefill-4096`` (1 x 4096) and ``decode-544`` (8 decode steps of 4
requests at positions 536-543 of a 544-slot cache); mamba2-2.7b
``mamba2-prefill-1024`` (4 x 1024), ``mamba2-prefill-4096`` (1 x 4096) and
``mamba2-decode`` (8 steps of 4 requests); zamba2-2.7b
``zamba2-prefill-1024`` and ``zamba2-decode`` (8 steps at positions
536-543); whisper-small ``whisper-prefill-448`` (4 x 448 tokens with 4 x
1500 frames) and ``whisper-decode`` (8 steps at positions 88-95, the
cache's ``enc_out`` zero, as ``greedy_generate``'s); internvl2-26b at 8
of its 48 layers (``SERVE_LAYERS``) ``internvl2-prefill-1024`` (4 x (256
patch embeddings + 768 tokens)) and ``internvl2-decode`` (8 steps at
positions 536-543); training cells run ``make_train_step`` from f32
masters (seed 0) on synthetic 4 x 1024-token batches, two steps before
the warm-up so that the caching allocator holds its blocks:
``mamba2-train`` (mamba2-2.7b at 16 of its 64 layers, remat "full", the
SSD scan and its backward through the kernels) and ``llama3-train``
(llama3-8b at 2 of its 32 layers, chunked attention).  It needs a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .core.params import NetworkSpec
from .sim.fabric import run_fabric_trace
from .sim.faults import NEVER, FaultSpec
from .sim.topology import full_bisection
from .sim.workloads import (RunConfig, _fabric_cfg, _scenario_ticks,
                            incast_scenario, permutation_scenario)

#: The chaos cells' fault schedule on ``full_bisection(32, 32)``: one entry
#: of each of the six classes (a mid-run link flap, a permanent uplink
#: flap, a host flap, a link at a quarter of its rate, a link and a host
#: link corrupting 20% of their data).  The JAX-made chaos reference
#: files (``testdata/perm1024_chaos_*_ref.json``) use it too.
CHAOS1024 = FaultSpec(link_flaps=((0, 0, 10, 60),),
                      uplink_flaps=((3, 3, 0, NEVER),),
                      host_flaps=((5, 30, 80),),
                      link_degrade=((1, 1, 0, 400, 0.25),),
                      link_corrupt=((2, 2, 0, 300, 0.2),),
                      host_corrupt=((7, 0, 300, 0.2),), seed=3)
#: The infer1024 cell's tenants: four open-loop inference tenants of 1024
#: messages each (16 KiB +- 50%, one arrival a tick on average, 16
#: frontend targets each), ``traffic.mixed_scenario`` with seed 0 on the
#: perm1024 fabric: 4096 flows whose last arrives at tick 1462, at most
#: 321-384 of them live at once, so ``active_cap=512`` runs 512 lanes
#: where the dense program runs 4096.
INFER1024_TENANTS = dict(n_flows=1024, mean_interarrival_ticks=1.0,
                         size_bytes=16 * 2 ** 10, size_jitter=0.5,
                         n_targets=16)
#: The active set's lane count at infer1024.
INFER1024_CAP = 512


def infer1024_scenario(shape=(32, 32)):
    """infer1024's trace (``traffic.mixed_scenario`` of four
    ``INFER1024_TENANTS`` tenants, seed 0, 400 Gbps) on
    ``full_bisection(*shape)``."""
    from .sim.traffic import InferenceTenant, mixed_scenario
    tenants = [InferenceTenant(f"inf{i}", **INFER1024_TENANTS)
               for i in range(4)]
    return mixed_scenario(full_bisection(*shape), (), tenants,
                          net=NetworkSpec(link_gbps=400.0), seed=0)[0]


#: The collective runs on the perm1024 fabric (400 Gbps, seed 0): name ->
#: ``collective_scenario``'s algorithm, jobs, ranks a job, bytes and
#: generator keywords.  ``hd1024`` is allreduce8k's job shape (HD
#: allreduce, 128 ranks, 128 KiB; ``benchmarks/perf.py``) eight times over
#: (14,336 messages, 13,312 edges); ``a2a1024`` is 32 windowed all-to-alls
#: of 32 ranks (31,744 messages, 31 flows a source).
COLLECTIVE1024 = {"hd1024": ("hd", 8, 128, 128 * 2 ** 10, {}),
                  "a2a1024": ("a2a", 32, 32, 512 * 2 ** 10, {"window": 8})}
#: allreduce8k's spot cell (``benchmarks/perf.py``): two HD allreduces of 8
#: ranks on ``full_bisection(4, 4)`` at 100 Gbps, under the active set.
ALLREDUCE8K_SPOT_CAP = 48


def collective1024_scenario(name: str, shape=(32, 32)):
    """The ``COLLECTIVE1024`` trace ``name`` on ``full_bisection(*shape)``
    (the perm1024 fabric by default)."""
    from .sim.workloads import collective_scenario
    algo, jobs, ranks, nbytes, kw = COLLECTIVE1024[name]
    return collective_scenario(full_bisection(*shape), algo, jobs, ranks,
                               nbytes, net=NetworkSpec(link_gbps=400.0),
                               seed=0, **kw)


def allreduce8k_spot_scenario():
    """allreduce8k's spot trace (run it at ``ALLREDUCE8K_SPOT_CAP``)."""
    from .sim.workloads import collective_scenario
    return collective_scenario(full_bisection(4, 4), "hd", 2, 8,
                               128 * 2 ** 10,
                               net=NetworkSpec(link_gbps=100.0), seed=0)


#: fabric scenario -> (traffic, fat-tree shape, RunConfig fields).
FABRIC = {"perm1024": ("perm", (32, 32), {}),
          "perm8k": ("perm", (128, 64), {}),
          "perm1024-rocev2": ("perm", (32, 32), {"protocol": "rocev2"}),
          "incast1024-rocev2": ("incast", (32, 32), {"protocol": "rocev2"}),
          "perm1024-chaos-strack": ("perm", (32, 32), {"faults": CHAOS1024}),
          "perm1024-chaos-rocev2": ("perm", (32, 32),
                                    {"protocol": "rocev2",
                                     "faults": CHAOS1024}),
          "infer1024-strack": ("infer", (32, 32),
                               {"active_cap": INFER1024_CAP}),
          "infer1024-rocev2": ("infer", (32, 32),
                               {"protocol": "rocev2",
                                "active_cap": INFER1024_CAP}),
          "infer1024-strack-dense": ("infer", (32, 32), {}),
          "hd1024": ("hd1024", (32, 32), {}),
          "hd1024-roce4": ("hd1024", (32, 32),
                           {"protocol": "rocev2", "subflows": 4}),
          "a2a1024": ("a2a1024", (32, 32), {})}
#: serve cell -> (model, requests, tokens).
SERVE = {"prefill-1000": ("llama3-8b", 4, 1000),
         "prefill-4096": ("llama3-8b", 1, 4096),
         "decode-544": ("llama3-8b", 4, 544),
         "mamba2-prefill-1024": ("mamba2-2.7b", 4, 1024),
         "mamba2-prefill-4096": ("mamba2-2.7b", 1, 4096),
         "mamba2-decode": ("mamba2-2.7b", 4, 544),
         "zamba2-prefill-1024": ("zamba2-2.7b", 4, 1024),
         "zamba2-decode": ("zamba2-2.7b", 4, 544),
         "whisper-prefill-448": ("whisper-small", 4, 448),
         "whisper-decode": ("whisper-small", 4, 96),
         "internvl2-prefill-1024": ("internvl2-26b", 4, 768),
         "internvl2-decode": ("internvl2-26b", 4, 544)}
#: Serve models profiled at a cut depth: model -> layers.
SERVE_LAYERS = {"internvl2-26b": 8}
#: training cell -> (model, layers, requests, tokens).
TRAIN = {"mamba2-train": ("mamba2-2.7b", 16, 4, 1024),
         "llama3-train": ("llama3-8b", 2, 4, 1024)}
#: CUDA kernel names of the hand-written kernels (csrc/*.cu).
OWN_KERNELS = ("strack_kernel", "roce_kernel", "serve_enqueue_kernel",
               "count_kernel", "scan_kernel", "resolve_kernel", "pfc_kernel",
               "fa_kernel", "tc_kernel", "dec_kernel",
               "ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
               "ssd_out_kernel", "ssd_bwd_q_kernel", "ssd_bwd_pass_kernel",
               "ssd_bwd_w_kernel", "ssd_bwd_dx_kernel",
               "ssd_bwd_dbc_kernel")


def _fabric_run(name: str):
    traffic, shape, kw = FABRIC[name]
    net = NetworkSpec(link_gbps=400.0)
    if traffic == "perm":
        sc = permutation_scenario(full_bisection(*shape), 64 * 2 ** 10,
                                  net=net, seed=0)
    elif traffic == "infer":
        sc = infer1024_scenario(shape)
    elif traffic in COLLECTIVE1024:
        sc = collective1024_scenario(traffic, shape)
    else:
        sc = incast_scenario(full_bisection(*shape), 256, 16 * 2 ** 10,
                             net=net)
    cfg = RunConfig(**kw)
    fcfg, n_ticks = _fabric_cfg(sc, cfg), _scenario_ticks(sc, cfg)

    def once():
        _, m = run_fabric_trace(sc.topo, sc.messages, n_ticks, fcfg,
                                device="cuda")
        return {"warp_trips": m["warp_trips"]}

    return once


def _serve_run(name: str, params, cfg):
    from .models import lm
    from .runtime.serve import make_decode_step, make_prefill_step
    _, B, T = SERVE[name]
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=g, device="cuda")
    batch = {"tokens": tokens}
    stub = {"encdec": ("frames", cfg.enc_seq),
            "vlm": ("vis_embed", cfg.n_vis_tokens)}.get(cfg.kind)
    if stub:
        batch[stub[0]] = torch.randn((B, stub[1], cfg.d_model), generator=g,
                                     device="cuda").to(torch.bfloat16)
    if "prefill" in name:
        prefill = make_prefill_step(cfg)
        return lambda: {"tokens": B * T,
                        "logits": tuple(prefill(params, batch).shape)}
    decode, steps = make_decode_step(cfg), 8

    def once():
        cache = lm.init_cache(cfg, B, T)
        for lc in cache["layers"] + cache.get("shared", []):
            lc["pos"] = T - steps
        for t in range(T - steps, T):
            decode(params, cache, tokens[:, t:t + 1], t)
        return {"decode_steps": steps, "requests": B}

    return once


def _train_run(name: str):
    from .configs import get_config
    from .runtime.data import DataConfig, SyntheticDataset
    from .runtime.optimizer import OptConfig
    from .runtime.train import init_train_state, make_train_step
    model, layers, B, T = TRAIN[name]
    cfg = dataclasses.replace(get_config(model), n_layers=layers)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = list(init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, opt_cfg))
    data = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq=T,
                                       global_batch=B, seed=0))
    step = make_train_step(cfg, opt_cfg)

    def once():
        state[0], state[1], m = step(state[0], state[1], next(data))
        return {"tokens": B * T, "loss": float(m["loss"])}

    once()
    once()
    return once


def profile(name: str, once) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    once()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        info = once()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    own = [r for r in rows if any(k in r[0] for k in OWN_KERNELS)]
    out = {
        "scenario": name, "device": torch.cuda.get_device_name(0),
        "wall_s": wall, **info,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "own_kernels_device_s": sum(r[1] for r in own) / 1e6,
        "device_launches": sum(r[2] for r in rows),
        "kernels": [{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                    for k, us, c in rows[:25]],
    }
    if "warp_trips" in info:
        trips = info["warp_trips"]
        out.update(wall_ms_per_trip=wall * 1e3 / trips,
                   device_busy_ms_per_trip=busy_us / 1e3 / trips,
                   device_launches_per_trip=out["device_launches"] / trips)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", nargs="+",
                    choices=sorted({**FABRIC, **SERVE, **TRAIN}),
                    default=["perm1024"])
    names = ap.parse_args().scenario
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.profile needs a CUDA device")
    params = cfg = once = None
    for name in names:
        if name in SERVE and (cfg is None or cfg.name != SERVE[name][0]):
            from .configs import get_config
            from .models import lm
            params = None
            torch.cuda.empty_cache()
            model = SERVE[name][0]
            cfg = dataclasses.replace(get_config(model), attn_impl="pallas",
                                      n_layers=SERVE_LAYERS.get(
                                          model, get_config(model).n_layers))
            params = lm.init_params(
                torch.Generator(device="cuda").manual_seed(0), cfg)
        if name in TRAIN:  # one model's training state on the card
            params = cfg = once = None
            torch.cuda.empty_cache()
            once = _train_run(name)
        else:
            once = (_fabric_run(name) if name in FABRIC
                    else _serve_run(name, params, cfg))
        print(json.dumps(profile(name, once), indent=1), flush=True)


if __name__ == "__main__":
    main()
