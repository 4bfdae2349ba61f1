"""Carry state between the JAX reference and the port.

The reference's state pytrees (``FlowState``, ``ReceiverState``,
``SackMsg``, ``PktQ``, ``FabricState``), given with numpy (or any
array-like) leaves, become the port's NamedTuples of tensors with the
same field names and dtypes, and back: :func:`to_numpy` returns the
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
from .models.lm import require_dense
from .sim.fabric import FabricState, PktQ

#: Sub-tree classes of the nested state tuples, by field name.
_NESTED = {
    FlowState: {"cc": CCState, "spray": SprayState, "rel": RelState},
    FabricState: {"flows": FlowState, "rcv": ReceiverState, "q": PktQ,
                  "pipe": SackMsg},
}


def to_torch(tree, cls, device="cpu"):
    """Reference pytree ``tree`` (NamedTuple with array-like leaves) ->
    the port's ``cls`` with tensor leaves on ``device``."""
    kids = _NESTED.get(cls, {})
    vals = []
    for name in cls._fields:
        v = getattr(tree, name)
        if name in kids:
            vals.append(to_torch(v, kids[name], device))
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



#: Norm weights (kept in f32); every other leaf is a matrix.
_NORMS = ("final_norm", "ln1", "ln2", "q_norm", "k_norm")


def lm_params_from_jax(np_params, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's dense-LM params (``repro.models.lm.init_params``'s
    tree with array-like leaves: f32 masters, layers stacked on a leading
    axis, e.g. ``layers/attn/wq`` of shape (n_layers, d, H*hd)) -> the
    port's params dict on ``device``, one dict per layer.  Matrix weights
    are cast once to ``cfg.dtype`` (the reference casts the same masters at
    every use), norm weights stay f32."""
    require_dense(cfg)
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)

    def leaf(a, name):
        t = torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
        return t if name in _NORMS else t.to(dt)

    def layer(tree, i):
        return {name: layer(v, i) if isinstance(v, dict) else leaf(v[i], name)
                for name, v in tree.items()}

    out = {name: leaf(np_params[name], name)
           for name in ("embed", "final_norm", "lm_head") if name in np_params}
    out["layers"] = [layer(np_params["layers"], i)
                     for i in range(cfg.n_layers)]
    return out
