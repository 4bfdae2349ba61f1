"""STrack on PyTorch and CUDA: the port of the JAX package ``repro``.

The JAX package stays the reference; this package imports ``torch`` and
never ``jax`` or anything of ``repro``.  Its layout mirrors the reference
so that each module's counterpart is easy to find:
``core/{params,cc,lb,reliability,transport}.py`` (per-flow STrack logic,
batched over flows), ``sim/{topology,fabric,workloads,traffic}.py`` (the
multi-queue fat-tree, its front door and the traffic generator),
``collective/algorithms.py`` (the collectives' message traces),
``kernels/fabric_kernels.py``
(the three fabric kernels, CUDA sources under ``kernels/csrc/``), and the
serving path of the dense, Mamba2 and hybrid language models:
``configs/``, ``models/{config,layers,ssm,lm}.py``, ``runtime/serve.py``,
``kernels/flash_attention.py`` and ``kernels/ssd_scan.py``, and their
training: ``runtime/{train,optimizer,data,checkpoint,elastic,tree}.py``
with the SSD scan's backward kernel.

Entry points take ``device`` and default to ``"cuda"``; without a GPU
they raise rather than fall back to the CPU.  The tests pass
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` without a visible
    GPU raises: nothing falls back to the CPU unless the caller asks."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda reports no "
            "GPU; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
