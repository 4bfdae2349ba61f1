"""The port's training loss and gradients against the JAX reference on
the CPU.

``lm_loss`` and the gradient of every parameter leaf for each
architecture's SMOKE config in f32, the same weights in both packages
(``tests/torch_lm_weights.py``, f32 masters: ``lm_params_from_jax(...,
masters=True)``), against ``jax.value_and_grad`` of the reference's
jitted ``lm_loss``; chunked attention's gradient; ``chunked_ce``; the
remat policies; ``cast_params`` and the masters
(``tests/test_torch_train_step.py`` holds ``make_train_step`` and the
committed training references).

Tolerances, relative to each leaf's (or value's) largest magnitude:
1e-5 for the attention kinds (observed 1.3e-6 - 2.6e-6).  The Mamba2
kinds run their block input and six projections in bf16 in both
packages, and their gradients pass through bf16 roundings of f32
cotangents that differ in the last bits, so an element rounds to the
other bf16 neighbour now and then and the difference grows through the
layers below: 2e-2 for their gradients, where the reference's own jitted
and op-by-op gradients differ by 8.3e-3 (mamba2) and 1.22e-2 (zamba2)
(observed port vs JAX: 7.8e-3 and 1.3e-2); their loss 2e-3, as served.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs
from repro.models import lm as JL

from repro_torch.configs import get_config
from repro_torch.convert import _port_tree, lm_params_from_jax
from repro_torch.models import lm as TL
from repro_torch.runtime.optimizer import OptConfig
from repro_torch.runtime.train import (_value_and_grad, init_train_state,
                                       make_train_step)
from repro_torch.runtime.tree import tree_leaves, tree_paths

from torch_lm_weights import lm_weights
from torch_parity import smoke_cfgs, train_batch

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

MAMBA2_KINDS = ("ssm", "hybrid")
GRAD_TOL = {"attention": 1e-5, "mamba2": 2e-2}
LOSS_TOL = {"attention": 1e-5, "mamba2": 2e-3}
B, T = 2, 16


def _family(cfg):
    return "mamba2" if cfg.kind in MAMBA2_KINDS else "attention"


def _jax_value_and_grad(cfg, w, batch):
    f = jax.jit(jax.value_and_grad(lambda p, b: JL.lm_loss(p, b, cfg)))
    loss, g = f(jax.tree.map(jnp.asarray, w),
                {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, g)


def _port_value_and_grad(tcfg, w, batch):
    params = lm_params_from_jax(w, tcfg, device="cpu", masters=True)
    loss, g = _value_and_grad(tcfg, params, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    return float(loss), g


def _leaf_errors(port_grads, jax_grads, tcfg) -> dict:
    want = dict(tree_paths(_port_tree(jax_grads, tcfg, "cpu")))
    got = dict(tree_paths(port_grads))
    assert got.keys() == want.keys()
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1e-30)) for k in got}


@pytest.mark.parametrize("arch", all_archs())
def test_lm_loss_and_every_gradient_leaf_match_jax(arch):
    cfg, tcfg = smoke_cfgs(arch)
    w = lm_weights(cfg, 0)
    batch = train_batch(cfg, 0, B, T)
    jl, jg = _jax_value_and_grad(cfg, w, batch)
    tl, tg = _port_value_and_grad(tcfg, w, batch)
    fam = _family(cfg)
    assert abs(tl - jl) <= LOSS_TOL[fam] * abs(jl), (tl, jl)
    errs = _leaf_errors(tg, jg, tcfg)
    bad = {k: e for k, e in errs.items() if not e <= GRAD_TOL[fam]}
    assert not bad, bad


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-small"])
def test_chunked_attention_gradients_match_jax(arch):
    """attn_impl="chunked" with chunks of 4 (no ragged chunk, C7 / C19
    not reached): the online softmax's gradient."""
    cfg, tcfg = smoke_cfgs(arch, attn_impl="chunked", attn_chunk=4)
    w = lm_weights(cfg, 0)
    batch = train_batch(cfg, 0, B, T)
    jl, jg = _jax_value_and_grad(cfg, w, batch)
    tl, tg = _port_value_and_grad(tcfg, w, batch)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert max(_leaf_errors(tg, jg, tcfg).values()) <= GRAD_TOL["attention"]


def test_chunked_ce_matches_jax_with_ignored_labels():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 48, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 37)) * 0.3).astype(np.float32)
    y = rng.integers(0, 37, (3, 48)).astype(np.int32)
    y[0, :20] = -1
    y[2, 5] = -1
    for chunk in (16, 48, 128):
        jv, (jh, jw) = jax.value_and_grad(
            lambda a, b: JL.chunked_ce(a, b, jnp.asarray(y), chunk),
            argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
        th = torch.from_numpy(h).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        tv = TL.chunked_ce(th, tw, torch.from_numpy(y), chunk)
        gh, gw = torch.autograd.grad(tv, (th, tw))
        assert abs(float(tv.detach()) - float(jv)) <= 1e-6 * abs(float(jv))
        np.testing.assert_allclose(gh.numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-6 * float(np.abs(jh).max()))
        np.testing.assert_allclose(gw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6 * float(np.abs(jw).max()))
    allneg = torch.full((3, 48), -1, dtype=torch.int32)
    assert float(TL.chunked_ce(torch.from_numpy(h), torch.from_numpy(w),
                               allneg)) == 0.0


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x22b",
                                  "zamba2-2.7b", "whisper-small"])
def test_remat_policies_give_equal_gradients(arch):
    """remat none, dots and full (and the chunked attention's
    ``attn_remat_chunk``) recompute the same numbers: equal gradients."""
    _, base = smoke_cfgs(arch, attn_impl="chunked", attn_chunk=4)
    w = lm_weights(base, 0)
    batch = train_batch(base, 0, B, T)
    grads = {}
    for remat in ("none", "dots", "full"):
        for chunk_remat in (False, True):
            tcfg = dataclasses.replace(base, remat=remat,
                                       attn_remat_chunk=chunk_remat)
            grads[(remat, chunk_remat)] = _port_value_and_grad(tcfg, w,
                                                               batch)
    (l0, g0) = grads[("none", False)]
    for key, (l, g) in grads.items():
        assert l == l0, key
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b), key


def test_cast_params_of_masters_equal_the_serve_params():
    for arch in ("llama3-8b", "zamba2-2.7b", "mixtral-8x22b"):
        cfg = get_config(arch, smoke=True)
        m = TL.init_params(torch.Generator().manual_seed(5), cfg,
                           masters=True)
        assert all(t.dtype == torch.float32 for t in tree_leaves(m))
        s = TL.init_params(torch.Generator().manual_seed(5), cfg)
        c = TL.cast_params(m, cfg)
        for (pa, a), (pb, b) in zip(tree_paths(c), tree_paths(s)):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
        assert all(x is y for x, y in zip(tree_leaves(TL.cast_params(s, cfg)),
                                          tree_leaves(s)))


def test_pallas_attention_refuses_to_train():
    _, tcfg = smoke_cfgs("llama3-8b", attn_impl="pallas")
    with pytest.raises(NotImplementedError, match="cannot differentiate"):
        make_train_step(tcfg, OptConfig(), device="cpu")


def test_init_train_state_is_f32_masters_and_zero_moments():
    cfg = get_config("mamba2-2.7b", smoke=True)
    opt_cfg = OptConfig(grad_compress=True)
    p, o = init_train_state(torch.Generator().manual_seed(0), cfg, opt_cfg)
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))
    for tree in (o.mu, o.nu, o.err):
        assert [t.shape for t in tree_leaves(tree)] == \
            [t.shape for t in tree_leaves(p)]
        assert all(not t.any() for t in tree_leaves(tree))
    assert int(o.count) == 0 and o.count.dtype == torch.int32
