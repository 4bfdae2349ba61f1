"""Checkpoints, restarts and the supervisor on the CPU: the port's
``runtime/checkpoint.py`` and ``runtime/elastic.py`` (the reference's
``repro/runtime/{checkpoint,elastic}.py`` and ``tests/test_runtime.py``,
``tests/test_elastic.py``), and a checkpoint the JAX package wrote,
continued by the port.

Bit-exact where the port restarts itself; against JAX's own continuation
of its checkpoint within float32 tolerances: the loss a step 1e-5
relative, every parameter within 1e-2 lr of JAX's (an Adam update lr g /
(sqrt(v) + eps) is sensitive to the last bits of a gradient within a few
eps of 0; observed 1.5e-3 lr after one step).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import checkpoint as JC
from repro.runtime.data import DataConfig as JDataConfig
from repro.runtime.data import SyntheticDataset as JDataset
from repro.runtime.optimizer import OptConfig as JOptConfig
from repro.runtime.optimizer import init_opt as j_init_opt
from repro.runtime.train import make_train_step as j_make_train_step

from repro_torch.configs import get_config
from repro_torch.convert import (_port_tree, lm_params_from_jax,
                                 opt_state_from_jax, restore_jax_checkpoint)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.data import DataConfig, SyntheticDataset
from repro_torch.runtime.elastic import (SupervisorConfig, TrainSupervisor,
                                         scale_batch_rule)
from repro_torch.runtime.optimizer import OptConfig
from repro_torch.runtime.train import init_train_state, make_train_step
from repro_torch.runtime.tree import tree_leaves, tree_paths

from torch_lm_weights import lm_weights
from torch_parity import jax_lm

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

CFG = get_config("llama3-8b", smoke=True)
F32_CFG = dataclasses.replace(CFG, dtype="float32")
KW = dict(lr=1e-3, warmup_steps=2, total_steps=50)
OPT = OptConfig(**KW)


def small_state(seed=0, cfg=CFG, opt=OPT):
    return init_train_state(torch.Generator().manual_seed(seed), cfg, opt)


def data(seed=0, vocab=CFG.vocab, seq=32, batch=4):
    return SyntheticDataset(DataConfig(vocab=vocab, seq=seq,
                                       global_batch=batch, seed=seed),
                            device="cpu")


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    params, opt = small_state()
    tree = {"params": params, "opt": opt,
            "bf16": torch.randn(3, 5).to(torch.bfloat16)}
    d = str(tmp_path)
    out = ckpt.save(d, 3, tree, extra={"data": {"step": 3, "seed": 0}})
    assert os.path.basename(out) == "step_00000003"
    assert ckpt.latest_step(d) == 3
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    assert manifest["leaves"]["opt__.count"] == {"shape": [],
                                                 "dtype": "int32"}
    assert manifest["leaves"]["bf16"]["dtype"] == "bfloat16"
    assert "params__layers__1__attn__wq" in manifest["leaves"]
    restored, extra = ckpt.restore(d, 3, tree, device="cpu")
    assert extra["data"]["step"] == 3
    assert _equal(restored, tree)
    assert isinstance(restored["opt"], type(opt))
    with pytest.raises(NotImplementedError, match="A11"):
        ckpt.restore(d, 3, tree, shardings={}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 3, {"params": {**params, "embed": torch.zeros(3)},
                            "opt": opt, "bf16": tree["bf16"]}, device="cpu")


def test_checkpoint_atomic_on_crash(tmp_path):
    """A partially-written checkpoint never shadows a complete one."""
    params, _ = small_state()
    d = str(tmp_path)
    ckpt.save(d, 1, {"params": params})
    os.makedirs(os.path.join(d, "step_00000002.tmp"), exist_ok=True)
    with open(os.path.join(d, "step_00000002.tmp", "junk.npy"), "w") as f:
        f.write("partial")
    assert ckpt.latest_step(d) == 1   # tmp is invisible
    ckpt.save(d, 2, {"params": params})   # and overwriting it works
    assert ckpt.latest_step(d) == 2
    assert not os.path.exists(os.path.join(d, "step_00000002.tmp"))
    assert ckpt.latest_step(os.path.join(d, "missing")) is None


def test_restart_is_bit_exact(tmp_path):
    """Kill-and-resume training reproduces the uninterrupted run exactly."""
    d = str(tmp_path)
    step_fn = make_train_step(CFG, OPT, device="cpu")
    params, opt = small_state()
    ds = data()
    for _ in range(6):
        params, opt, _ = step_fn(params, opt, next(ds))
    ref = (params, opt)
    params, opt = small_state()
    ds = data()
    for _ in range(3):
        params, opt, _ = step_fn(params, opt, next(ds))
    ckpt.save(d, 3, {"params": params, "opt": opt},
              extra={"data": ds.state_dict()})
    del params, opt, ds
    like_p, like_o = small_state(seed=9)
    restored, extra = ckpt.restore(d, 3, {"params": like_p, "opt": like_o},
                                   device="cpu")
    ds2 = data()
    ds2.load_state_dict(extra["data"])
    params, opt = restored["params"], restored["opt"]
    for _ in range(3):
        params, opt, _ = step_fn(params, opt, next(ds2))
    assert _equal((params, opt), ref)


def _jax_state_and_data():
    cfg, params = jax_lm("llama3-8b", "float32", 0)
    jopt = JOptConfig(**KW)
    return cfg, params, j_init_opt(params, jopt), jopt, JDataset(
        JDataConfig(vocab=cfg.vocab, seq=32, global_batch=4, seed=0))


def test_jax_checkpoint_continued_by_the_port(tmp_path):
    """The reference trains 3 steps and saves; the port restores that
    directory (``restore_jax_checkpoint``) and trains 3 more steps, as the
    reference does from the same directory."""
    cfg, params, opt, jopt, ds = _jax_state_and_data()
    step = jax.jit(j_make_train_step(cfg, jopt))
    for _ in range(3):
        params, opt, _ = step(params, opt, next(ds))
    d = str(tmp_path)
    JC.save(d, 3, {"params": params, "opt": opt},
            extra={"data": ds.state_dict(), "step": 3})
    (tp, to), extra = restore_jax_checkpoint(d, 3, F32_CFG, device="cpu")
    assert extra == {"data": {"step": 3, "seed": 0}, "step": 3}
    assert int(to.count) == 3
    # the restored state is the JAX state, leaf for leaf
    assert _equal(tp, lm_params_from_jax(jax.tree.map(np.asarray, params),
                                         F32_CFG, "cpu", masters=True))
    assert _equal(to, opt_state_from_jax(jax.tree.map(np.asarray, opt),
                                         F32_CFG, "cpu"))
    tds = data()
    tds.load_state_dict(extra["data"])
    tstep = make_train_step(F32_CFG, OPT, device="cpu")
    for _ in range(3):
        jb = next(ds)
        tb = next(tds)
        assert np.array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
        params, opt, jm = step(params, opt, jb)
        tp, to, tm = tstep(tp, to, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= 1e-5 * float(jm["loss"])
        assert np.float32(tm["lr"]) == np.asarray(jm["lr"])
    want = dict(tree_paths(_port_tree(jax.tree.map(np.asarray, params),
                                      F32_CFG, "cpu")))
    for path, leaf in tree_paths(tp):
        assert float((leaf - want[path]).abs().max()) <= 1e-2 * KW["lr"], \
            path


def test_restore_jax_checkpoint_of_a_compressing_hybrid(tmp_path):
    """zamba2 SMOKE (the shared block, stacked SSM layers) with gradient
    compression (the residual shaped like the params): every leaf of the
    reference's tree lands in the port's layout."""
    from repro.configs import get_config as j_get_config
    jcfg = dataclasses.replace(j_get_config("zamba2-2.7b", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True),
                               dtype="float32")
    w = jax.tree.map(jnp.asarray, lm_weights(jcfg, 0))
    opt = j_init_opt(w, JOptConfig(grad_compress=True))
    opt = opt._replace(mu=jax.tree.map(lambda a: a + 1.0, opt.mu),
                       count=jnp.asarray(7, jnp.int32))
    JC.save(str(tmp_path), 7, {"params": w, "opt": opt}, extra={"step": 7})
    (tp, to), extra = restore_jax_checkpoint(str(tmp_path), 7, tcfg,
                                             device="cpu")
    assert extra == {"step": 7} and int(to.count) == 7
    assert len(tp["layers"]) == tcfg.n_layers and "shared_attn" in tp
    assert [t.shape for t in tree_leaves(to.err)] == \
        [t.shape for t in tree_leaves(tp)]
    assert all(bool((t == 1.0).all()) for t in tree_leaves(to.mu))
    wq = np.asarray(w["shared_attn"]["attn"]["wq"])
    assert np.array_equal(tp["shared_attn"]["attn"]["wq"].numpy(), wq)
    assert np.array_equal(tp["layers"][3]["ssm"]["w_x"].numpy(),
                          np.asarray(w["layers"]["ssm"]["w_x"][3]))


def _supervised(tmp, fail_at, ckpt_every=4, n=10):
    cfg = get_config("qwen3-4b", smoke=True)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    params, state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                     opt)
    ds = data(seed=3, vocab=cfg.vocab, seq=16, batch=2)
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp),
                                           ckpt_every=ckpt_every),
                          (params, state), ds,
                          make_train_step(cfg, opt, device="cpu"))
    return sup, sup.run(n, fail_at=fail_at)


def test_failures_recovered_bit_exact(tmp_path):
    _, ref = _supervised(tmp_path / "a", None)
    sup, got = _supervised(tmp_path / "b", {3, 7})
    assert sup.restarts == 2
    assert _equal(ref, got)
    steps = [s for s, _ in sup.metrics_log]
    assert set(range(10)).issubset(steps)
    assert steps.count(3) == 1 and steps.count(1) == 2  # redone from step 0
    assert ckpt.latest_step(str(tmp_path / "b")) == 10


RESUME_CHILD = """
import sys, torch
from repro_torch.configs import get_config
from repro_torch.runtime.data import DataConfig, SyntheticDataset
from repro_torch.runtime.elastic import SupervisorConfig, TrainSupervisor
from repro_torch.runtime.optimizer import OptConfig
from repro_torch.runtime.train import init_train_state, make_train_step
cfg = get_config("qwen3-4b", smoke=True)
opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100)
like = init_train_state(torch.Generator().manual_seed(9), cfg, opt)
ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq=16, global_batch=2,
                                 seed=3), device="cpu")
TrainSupervisor(SupervisorConfig(ckpt_dir=sys.argv[1], ckpt_every=4), like,
                ds, make_train_step(cfg, opt, device="cpu")).run(
    10, resume=True)
"""


def test_a_restarted_process_resumes_bit_exact(tmp_path):
    """A node failure that ends the process: the supervisor gives up at
    step 7 (no restarts allowed), a fresh Python process resumes from the
    step-4 checkpoint with ``run(resume=True)``, and the step-10
    checkpoint equals the uninterrupted run's bit for bit."""
    import subprocess
    import sys
    _, ref = _supervised(tmp_path / "a", None)
    cfg = get_config("qwen3-4b", smoke=True)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
                         max_restarts=0),
        init_train_state(torch.Generator().manual_seed(0), cfg, opt),
        data(seed=3, vocab=cfg.vocab, seq=16, batch=2),
        make_train_step(cfg, opt, device="cpu"))
    with pytest.raises(RuntimeError, match="injected"):
        sup.run(10, fail_at={7})
    assert ckpt.latest_step(str(tmp_path / "b")) == 4
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", RESUME_CHILD, str(tmp_path / "b")],
                   check=True, env=env, timeout=300)
    assert ckpt.latest_step(str(tmp_path / "b")) == 10
    got, _ = ckpt.restore(str(tmp_path / "b"), 10,
                          {"params": ref[0], "opt": ref[1]}, device="cpu")
    assert _equal(ref, (got["params"], got["opt"]))


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    cfg = get_config("qwen3-4b", smoke=True)
    params, state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                     OPT)

    def broken(p, o, b):
        raise RuntimeError("node lost")
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                           max_restarts=2),
                          (params, state), data(vocab=cfg.vocab), broken)
    with pytest.raises(RuntimeError, match="node lost"):
        sup.run(3)
    assert sup.restarts == 3
    with pytest.raises(NotImplementedError, match="A11"):
        TrainSupervisor(SupervisorConfig(), (params, state), None, broken,
                        shardings={})


def test_scale_batch_rule():
    assert scale_batch_rule(256, 8, 512, 256) == 16   # half chips -> 2x accum
    assert scale_batch_rule(256, 8, 256, 512) == 4
    assert scale_batch_rule(256, 1, 256, 999) == 1
    assert scale_batch_rule(256, 3, 4, 8) == 2        # rounded up
