"""Where a fabric run's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.profile [--scenario perm1024]

Runs one scenario through ``run_fabric_trace`` on the card twice (the
first run warms up: it builds the kernels and PyTorch's caches) and
profiles the second with ``torch.profiler``: wall time, warp trips, the
device-busy share (summed kernel time over wall time), the three
hand-written fabric kernels' device time, and device time by kernel for
the 25 largest.  It needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .core.params import NetworkSpec
from .sim.fabric import run_fabric_trace
from .sim.topology import full_bisection
from .sim.workloads import (RunConfig, _fabric_cfg, _scenario_ticks,
                            permutation_scenario)

SCENARIOS = {"perm1024": (32, 32), "perm8k": (128, 64)}
#: CUDA kernel names of the three fabric kernels (csrc/*.cu).
OWN_KERNELS = ("apply_kernel", "commit_kernel", "serve_kernel",
               "accept_kernel", "place_kernel", "count_kernel",
               "scan_kernel", "resolve_kernel")


def profile(name: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.profile needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile as tprofile
    sc = permutation_scenario(full_bisection(*SCENARIOS[name]),
                              64 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = RunConfig()
    fcfg, n_ticks = _fabric_cfg(sc, cfg), _scenario_ticks(sc, cfg)

    def once():
        t0 = time.time()
        _, m = run_fabric_trace(sc.topo, sc.messages, n_ticks, fcfg,
                                device="cuda")
        torch.cuda.synchronize()
        return time.time() - t0, m

    once()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        wall, m = once()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    own = [r for r in rows if any(k in r[0] for k in OWN_KERNELS)]
    return {
        "scenario": name, "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "warp_trips": m["warp_trips"],
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "fabric_kernels_device_s": sum(r[1] for r in own) / 1e6,
        "kernels": [{"name": k[:90], "device_ms": us / 1e3, "calls": c}
                    for k, us, c in rows[:25]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    default="perm1024")
    print(json.dumps(profile(ap.parse_args().scenario), indent=1))


if __name__ == "__main__":
    main()
