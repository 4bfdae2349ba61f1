"""Carry state between the JAX reference and the port.

The reference's state pytrees (``FlowState``, ``ReceiverState``,
``SackMsg``, ``PktQ``, ``FabricState``, and RoCEv2's ``RoceFlow``,
``RoceRcv``, ``RoceMsg``), given with numpy (or any array-like) leaves,
become the port's NamedTuples of tensors with the same field names and
dtypes (a faulted ``FabricState`` too: its chaos counters, and
``win_retx`` with one entry per flap window; a capped one with its
``act_overflow`` count), and back: :func:`to_numpy` returns the
port's classes with numpy leaves, so a test can diff the two packages
leaf by leaf after feeding both the same state.  :func:`lm_params_from_jax`
carries a language model's weights across.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.cc import CCState
from .core.lb import SprayState
from .core.reliability import ReceiverState, RelState, SackMsg
from .core.transport import FlowState
from .models import layers as L
from .models.config import ModelConfig
from .models.lm import require_ported
from .models.ssm import BF16, PROJECTIONS
from .sim.dcqcn_fab import RoceFlow, RoceMsg, RoceRcv
from .sim.fabric import FabricState, PktQ

#: Sub-tree classes of the nested state tuples, by field name.
_NESTED = {
    FlowState: {"cc": CCState, "spray": SprayState, "rel": RelState},
    FabricState: {"flows": FlowState, "rcv": ReceiverState, "q": PktQ,
                  "pipe": SackMsg},
}
#: The port's class of a sub-tree whose class the field does not fix (a
#: fabric state's flows, receivers and pipe under RoCEv2), by class name.
_BY_NAME = {c.__name__: c for c in (FlowState, ReceiverState, SackMsg,
                                    RoceFlow, RoceRcv, RoceMsg)}


def to_torch(tree, cls, device="cpu"):
    """Reference pytree ``tree`` (NamedTuple with array-like leaves) ->
    the port's ``cls`` with tensor leaves on ``device``."""
    kids = _NESTED.get(cls, {})
    vals = []
    for name in cls._fields:
        v = getattr(tree, name)
        if name in kids:
            kid = _BY_NAME.get(type(v).__name__, kids[name])
            vals.append(to_torch(v, kid, device))
        else:
            vals.append(torch.from_numpy(np.array(v)).to(device))
    return cls(*vals)


def to_numpy(tree):
    """Port tuple of tensors -> the same tuple class with numpy leaves."""
    if isinstance(tree, tuple):
        return type(tree)(*[to_numpy(v) for v in tree])
    return tree.detach().cpu().numpy()


def leaves(tree, prefix: str = "") -> dict:
    """``{"flows.rel.epsn": array, ...}`` for a NamedTuple of array-likes
    (either package's classes)."""
    out = {}
    for name in tree._fields:
        v = getattr(tree, name)
        key = f"{prefix}{name}"
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update(leaves(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out



#: Norm weights (kept in f32); every other dense-block leaf is a matrix.
_NORMS = ("final_norm", "enc_norm", "ln1", "ln2", "ln_x", "q_norm",
          "k_norm")


def lm_params_from_jax(np_params, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's LM params (``repro.models.lm.init_params``'s tree
    with array-like leaves: f32 masters, layers stacked on a leading axis,
    e.g. ``layers/attn/wq`` of shape (n_layers, d, H*hd),
    ``layers/moe/router`` (n_layers, d, E) and ``layers/moe/wg`` (n_layers,
    E, d, ff) or ``layers/ssm/w_x`` of shape (n_layers, d, d_in); the
    hybrid's
    ``shared_attn``, one unstacked dense block; encdec's ``enc_layers``,
    stacked too, and ``enc_norm``) -> the port's params dict on
    ``device``, one dict per layer.  The reference casts the same f32
    masters at every use; the port casts once: dense and MoE matrices
    (router and experts) to ``cfg.dtype``, the Mamba2 projections to bf16 (``ssm.py`` casts them
    to bf16 whatever ``cfg.dtype`` is); norm weights and the Mamba2
    block's other leaves (conv kernels and biases, ``A_log``, ``D``,
    ``dt_bias``, ``norm_w``) stay f32."""
    require_ported(cfg)
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)

    def leaf(a, name, in_ssm=False):
        t = torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
        if in_ssm:
            return t.to(BF16) if name in PROJECTIONS else t
        return t if name in _NORMS else t.to(dt)

    def block(tree, pick=lambda a: a, in_ssm=False):
        return {name: (block(v, pick, in_ssm or name == "ssm")
                       if isinstance(v, dict) else leaf(pick(v), name, in_ssm))
                for name, v in tree.items()}

    out = {name: leaf(np_params[name], name)
           for name in ("embed", "final_norm", "lm_head", "enc_norm")
           if name in np_params}
    out["layers"] = [block(np_params["layers"], lambda a, i=i: a[i])
                     for i in range(cfg.n_layers)]
    if cfg.kind == "encdec":
        out["enc_layers"] = [block(np_params["enc_layers"],
                                   lambda a, i=i: a[i])
                             for i in range(cfg.n_enc_layers)]
    if cfg.kind == "hybrid":
        out["shared_attn"] = block(np_params["shared_attn"])
    return out
