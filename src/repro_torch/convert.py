"""Carry state between the JAX reference and the port.

The reference's state pytrees (``FlowState``, ``ReceiverState``,
``SackMsg``, ``PktQ``, ``FabricState``), given with numpy (or any
array-like) leaves, become the port's NamedTuples of tensors with the
same field names and dtypes, and back: :func:`to_numpy` returns the
port's classes with numpy leaves, so a test can diff the two packages
leaf by leaf after feeding both the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.cc import CCState
from .core.lb import SprayState
from .core.reliability import ReceiverState, RelState, SackMsg
from .core.transport import FlowState
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

