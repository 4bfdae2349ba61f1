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
carries a language model's weights across, :func:`opt_state_from_jax` its
optimizer state, and :func:`restore_jax_checkpoint` a training
checkpoint the reference wrote.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.cc import CCState
from .core.lb import SprayState
from .core.reliability import ReceiverState, RelState, SackMsg
from .core.transport import FlowState
from .models.config import ModelConfig
from .models.lm import cast_params, require_ported
from .runtime.optimizer import OptState
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



def _port_tree(np_tree, cfg: ModelConfig, dev) -> dict:
    """A tree shaped like the reference's LM params (array-like leaves,
    layers stacked on a leading axis) -> the port's layout in f32 on
    ``dev``: one dict per layer.  A leaf of shape () is the same for every
    layer (the reference's optimizer keeps one zero a leaf for the
    residual when compression is off)."""
    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def block(tree, pick=lambda a: a):
        return {name: (block(v, pick) if isinstance(v, dict)
                       else leaf(pick(v)))
                for name, v in tree.items()}

    def layer(i):
        return lambda a: a[i] if np.ndim(a) else a

    out = {name: leaf(np_tree[name])
           for name in ("embed", "final_norm", "lm_head", "enc_norm")
           if name in np_tree}
    out["layers"] = [block(np_tree["layers"], layer(i))
                     for i in range(cfg.n_layers)]
    if cfg.kind == "encdec":
        out["enc_layers"] = [block(np_tree["enc_layers"], layer(i))
                             for i in range(cfg.n_enc_layers)]
    if cfg.kind == "hybrid":
        out["shared_attn"] = block(np_tree["shared_attn"])
    return out


def lm_params_from_jax(np_params, cfg: ModelConfig, device="cuda",
                       masters: bool = False) -> dict:
    """The reference's LM params (``repro.models.lm.init_params``'s tree
    with array-like leaves: f32 masters, layers stacked on a leading axis,
    e.g. ``layers/attn/wq`` of shape (n_layers, d, H*hd),
    ``layers/moe/router`` (n_layers, d, E) and ``layers/moe/wg`` (n_layers,
    E, d, ff) or ``layers/ssm/w_x`` of shape (n_layers, d, d_in); the
    hybrid's ``shared_attn``, one unstacked dense block; encdec's
    ``enc_layers``, stacked too, and ``enc_norm``) -> the port's params
    dict on ``device``, one dict per layer.  With ``masters`` every leaf
    stays f32, for training.  Otherwise the casts the reference makes at
    every use are made once (:func:`repro_torch.models.lm.cast_params`):
    dense and MoE matrices (router and experts) to ``cfg.dtype``, the
    Mamba2 projections to bf16 (``ssm.py`` casts them to bf16 whatever
    ``cfg.dtype`` is); norm weights and the Mamba2 block's other leaves
    (conv kernels and biases, ``A_log``, ``D``, ``dt_bias``, ``norm_w``)
    stay f32."""
    require_ported(cfg)
    tree = _port_tree(np_params, cfg, resolve_device(device))
    return tree if masters else cast_params(tree, cfg)


def opt_state_from_jax(np_opt, cfg: ModelConfig, device="cuda") -> OptState:
    """The reference's ``OptState`` (array-like leaves; ``mu``, ``nu`` and
    ``err`` shaped like its params, ``err`` one zero a leaf when
    compression is off) -> the port's, unstacked per layer as the params
    are (:func:`lm_params_from_jax`), ``count`` an int32 scalar."""
    dev = resolve_device(device)
    mu, nu, count, err = np_opt
    return OptState(mu=_port_tree(mu, cfg, dev), nu=_port_tree(nu, cfg, dev),
                    count=torch.tensor(int(np.asarray(count)),
                                       dtype=torch.int32, device=dev),
                    err=_port_tree(err, cfg, dev))


def restore_jax_checkpoint(ckpt_dir: str, step: int, cfg: ModelConfig,
                           device="cuda") -> tuple:
    """A ``step_<N>`` directory that ``repro.runtime.checkpoint.save``
    wrote of ``{"params": ..., "opt": OptState}`` -> ``((params, opt),
    extra)``: the port's f32 master params and optimizer state on
    ``device`` (the reference's stacked leaves, e.g.
    ``params__layers__attn__wq``, become one dict per layer) and the
    manifest's ``extra`` (the data pipeline's state, the step)."""
    import json
    import os
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tree: dict = {}
    for name in manifest["leaves"]:
        *keys, last = name.split("__")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = np.load(os.path.join(d, name + ".npy"))
    opt = tree["opt"]
    np_opt = (opt[".mu"], opt[".nu"], opt[".count"], opt[".err"])
    return ((lm_params_from_jax(tree["params"], cfg, device, masters=True),
             opt_state_from_jax(np_opt, cfg, device)), manifest["extra"])
