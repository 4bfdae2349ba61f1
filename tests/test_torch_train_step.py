"""The port's ``make_train_step`` against the JAX reference's on the CPU:
one step from the same f32 masters at 1, 2 and 4 micro-batches, with and
without int8 gradient compression (metrics and every updated leaf); the
micro-batches' gradients summed in the reference's order; and the four
committed training references (``src/repro_torch/testdata/
*_smoke_train_ref.json``: four steps of the llama3-8b, mamba2-2.7b,
mixtral-8x22b and whisper-small SMOKE configs) rebuilt from JAX and
matched by the port.  Tolerances, relative: 1e-5 for the attention
models; 2e-3 for the Mamba2 models' loss (bf16 projections, as
``tests/test_torch_train.py`` says); 2e-3 for a run with int8 gradient
compression (an int8 code whose gradient sits near a half step rounds the
other way and moves its dequantised gradient by amax / 127; observed
9.2e-4).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.optimizer import OptConfig as JOptConfig
from repro.runtime.optimizer import init_opt as j_init_opt
from repro.runtime.train import make_train_step as j_make_train_step

from repro_torch.configs import get_config
from repro_torch.convert import _port_tree, lm_params_from_jax
from repro_torch.runtime.optimizer import OptConfig, init_opt
from repro_torch.runtime.train import _value_and_grad, make_train_step
from repro_torch.runtime.tree import tree_paths

from torch_lm_weights import TRAIN_REF, lm_weights, port_train_run
from torch_parity import (TRAIN_REF_PATHS, smoke_cfgs, smoke_train_reference,
                          train_batch)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

MAMBA2_KINDS = ("ssm", "hybrid")
TOL = {"attention": 1e-5, "mamba2": 2e-3, "compress": 2e-3}


def _jax_step(cfg, w, batch, opt_cfg, micro_batches):
    jp = jax.tree.map(jnp.asarray, w)
    step = jax.jit(j_make_train_step(cfg, opt_cfg,
                                     micro_batches=micro_batches))
    p, o, m = step(jp, j_init_opt(jp, opt_cfg),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, p), {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("micro_batches,compress",
                         [(1, False), (4, False), (1, True), (2, True)])
def test_train_step_matches_jax(micro_batches, compress):
    """One step of ``make_train_step`` from the same masters: the metrics
    and every updated parameter leaf (llama3-8b SMOKE, f32, batch 4)."""
    cfg, tcfg = smoke_cfgs("llama3-8b")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50, grad_compress=compress)
    w = lm_weights(cfg, 0)
    batch = train_batch(cfg, 0, 4, 16)
    jp, jm = _jax_step(cfg, w, batch, JOptConfig(**kw), micro_batches)
    params = lm_params_from_jax(w, tcfg, device="cpu", masters=True)
    opt_cfg = OptConfig(**kw)
    step = make_train_step(tcfg, opt_cfg, micro_batches=micro_batches,
                           device="cpu")
    tp, _, tm = step(params, init_opt(params, opt_cfg),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = TOL["compress"] if compress else TOL["attention"]
    assert float(tm["lr"]) == jm["lr"]
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - jm[k]) <= tol * abs(jm[k]), (k, tm, jm)
    # the first Adam step moves a parameter by lr * g / (|g| + eps): an
    # element whose gradient is within a few eps (1e-8) of 0 moves by a
    # share of lr that the gradient's last bits decide (observed 1.5e-3
    # lr on the embedding); an int8 code rounded the other way moves its
    # element by a share of one step
    want = dict(tree_paths(_port_tree(jp, tcfg, "cpu")))
    for path, leaf in tree_paths(tp):
        d = float((leaf - want[path]).abs().max())
        assert d <= (1.0 if compress else 1e-2) * kw["lr"], (path, d)


def test_micro_batches_sum_in_the_references_order():
    """micro_batches=4 sums four gradient trees from zeros, then divides:
    the port's accumulated gradient equals that sum made by hand."""
    _, tcfg = smoke_cfgs("llama3-8b")
    w = lm_weights(tcfg, 0)
    batch = {k: torch.from_numpy(v)
             for k, v in train_batch(tcfg, 0, 4, 16).items()}
    params = lm_params_from_jax(w, tcfg, device="cpu", masters=True)
    seen = []
    import repro_torch.runtime.train as train_mod
    real = train_mod.apply_updates

    def spy(p, g, s, c):
        seen.append(g)
        return real(p, g, s, c)
    train_mod.apply_updates = spy
    try:
        opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
        make_train_step(tcfg, opt_cfg, micro_batches=4, device="cpu")(
            params, init_opt(params, opt_cfg), batch)
    finally:
        train_mod.apply_updates = real
    parts = [_value_and_grad(tcfg, params, {k: v[i:i + 1]
                                            for k, v in batch.items()})[1]
             for i in range(4)]
    for path, got in tree_paths(seen[0]):
        acc = torch.zeros_like(got)
        for part in parts:
            acc = acc + dict(tree_paths(part))[path]
        assert torch.equal(got, acc / 4), path


@pytest.mark.parametrize("arch", list(TRAIN_REF))
def test_training_reference_file_and_port(arch):
    """The committed training reference equals a fresh JAX run, and the
    port's run (tokens, loss, grad_norm and lr a step) matches it."""
    path = TRAIN_REF_PATHS[arch]
    committed = json.loads(path.read_text())
    assert committed == json.loads(json.dumps(smoke_train_reference(arch)))
    toks, got, _ = port_train_run(arch, "cpu")
    assert toks.tolist() == committed["tokens"]
    ref = TRAIN_REF[arch]
    cfg = get_config(arch, smoke=True)
    tol = TOL["compress" if ref["grad_compress"] else
              "mamba2" if cfg.kind in MAMBA2_KINDS else "attention"]
    # the file keeps 9 significant digits: a float32 exactly
    assert np.array_equal(np.float32(got["lr"]), np.float32(committed["lr"]))
    for k in ("loss", "grad_norm"):
        for a, b in zip(got[k], committed[k]):
            assert abs(a - b) <= tol * abs(b), (arch, k, got[k],
                                                committed[k])
