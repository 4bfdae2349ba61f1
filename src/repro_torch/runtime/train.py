"""Train-step factory: loss, gradients and AdamW, with micro-batch
gradient accumulation (the reference's ``repro/runtime/train.py``).

The parameters are f32 masters (:func:`repro_torch.models.lm.init_params`
or :func:`repro_torch.convert.lm_params_from_jax` with ``masters=True``);
:func:`repro_torch.models.lm.lm_loss` casts them at use, so the gradients
are f32 and land on the masters.  Attention trains through
``attn_impl="naive"`` or ``"chunked"`` (the config default): the
reference cannot differentiate its Pallas kernels (``jax.grad`` through
them raises), and neither path has a gradient through the port's
flash-attention kernel, so ``"pallas"`` raises.  The SSD scan trains
through its CUDA kernel and the kernel's backward
(:class:`repro_torch.kernels.ssd_scan.SsdScanFn`) on the card, through
the plain chunked scan on the CPU.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from .optimizer import OptConfig, OptState, apply_updates, init_opt
from .tree import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


def _value_and_grad(cfg: ModelConfig, params, batch) -> tuple:
    """(loss, gradient tree) of ``lm_loss`` at ``params``; the params are
    taken as leaves that need a gradient without copying them."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = lm.lm_loss(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    micro_batches: int = 1, device="cuda"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``metrics = {"loss", "grad_norm", "lr"}``.

    With ``micro_batches > 1`` the batch is split along dim 0 and the
    gradients are summed in f32 in the reference's order (``g0 + g1 +
    ...`` from zeros), then divided, as is the loss; the optimizer runs
    once a step."""
    lm.require_ported(cfg)
    if cfg.attn_impl == "pallas":
        raise NotImplementedError(
            "make_train_step: attn_impl='pallas' has no gradient: the "
            "reference cannot differentiate its Pallas kernels either "
            "(jax.grad through them raises); train with attn_impl="
            "'chunked' (the config default) or 'naive'")
    if micro_batches < 1:
        raise ValueError(f"micro_batches {micro_batches} < 1")
    dev = resolve_device(device)

    def train_step(params, opt_state: OptState, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        if micro_batches == 1:
            loss, grads = _value_and_grad(cfg, params, batch)
        else:
            def part(x, i):
                b = x.shape[0]
                if b % micro_batches:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"micro_batches {micro_batches}")
                n = b // micro_batches
                return x[i * n:(i + 1) * n]
            loss = torch.zeros((), dtype=F32, device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                   device=dev), params)
            for i in range(micro_batches):
                mb = {k: part(v, i) for k, v in batch.items()}
                l, g = _value_and_grad(cfg, params, mb)
                grads = tree_map(lambda a, b: a + b, grads, g)
                loss = loss + l
            loss = loss / micro_batches
            grads = tree_map(lambda g: g / micro_batches, grads)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: OptConfig) -> tuple:
    """(f32 master params from ``gen`` on its device, fresh optimizer
    state)."""
    params = lm.init_params(gen, cfg, masters=True)
    return params, init_opt(params, opt_cfg)
