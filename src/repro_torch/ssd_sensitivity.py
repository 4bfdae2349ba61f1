"""How far Mamba2's prefill logits move when the SSD scan's output moves.

    PYTHONPATH=src python -m repro_torch.ssd_sensitivity [--eps 1e-8 1e-7]

Runs mamba2-2.7b in bf16 at full width and depth, random weights from
seed 0, on 4 x 1024 random tokens, with the SSD scan through its plain
version (``kernels.ref.ssd_chunked_ref``); then again with the scan's
output y times (1 + eps z), z standard normal, for each eps; and once at
chunk 64 (another exact summation of the same scan).  It prints the
relative L2 distance of each run's logits from the first as one JSON
object.  ``chip_smoke.py`` holds the SSD kernel's logits within
SERVE_REL_L2 of the plain version's: these distances say how close to
the plain version's bits a scan must stay to pass it.  It needs a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from .kernels import ops as kops
from .kernels.ref import ssd_chunked_ref


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def sensitivity(cfg, params, tokens: torch.Tensor, eps_list,
                seed: int = 5) -> dict:
    """The relative L2 distances of the prefill logits from the plain
    scan's: at chunk 64, and with y times (1 + eps z) for each eps."""
    from .runtime.serve import make_prefill_step
    dev = tokens.device
    noise = torch.Generator(device=dev).manual_seed(seed)
    kernel = kops.ssd_scan

    def logits(c, eps=0.0):
        def plain(x, dt, A, B_, C_, chunk=128, *, final_state=False):
            y, state = ssd_chunked_ref(x, dt, A, B_, C_, chunk)
            if eps:
                y = y * (1 + eps * torch.randn(y.shape, generator=noise,
                                               device=dev))
            y = y.to(x.dtype)
            return (y, state) if final_state else y
        kops.ssd_scan = plain
        try:
            return make_prefill_step(c, dev)(params, {"tokens": tokens})
        finally:
            kops.ssd_scan = kernel

    want = logits(cfg)
    return {"chunk64_rel_l2": rel_l2(
                logits(dataclasses.replace(cfg, ssm_chunk=64)), want),
            "perturbed_rel_l2": {f"{e:g}": rel_l2(logits(cfg, e), want)
                                 for e in eps_list}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eps", nargs="+", type=float, default=[1e-8, 1e-7])
    eps_list = ap.parse_args().eps
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.ssd_sensitivity needs a CUDA device")
    from .configs import get_config
    from .models import lm
    cfg = get_config("mamba2-2.7b")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    print(json.dumps({"model": cfg.name, "tokens": list(tokens.shape),
                      "device": torch.cuda.get_device_name(0),
                      **sensitivity(cfg, params, tokens, eps_list)}))


if __name__ == "__main__":
    main()
