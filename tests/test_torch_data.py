"""The port's synthetic data pipeline (``repro_torch.runtime.data``)
against the reference's (``repro/runtime/data.py``) on the CPU: the
threefry2x32 primitives and the batches' tokens bit for bit, resuming
from ``state_dict``, and the extras' keys (ROADMAP C21: the reference
keys an extra with ``hash(name)``, salted per process; the port with a
stable hash, so two processes draw the same extras)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.data import DataConfig as JDataConfig
from repro.runtime.data import SyntheticDataset as JDataset

from repro_torch.runtime import data as TD

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

ROOT = Path(__file__).resolve().parents[1]


def _key_data(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)
                                            if hasattr(jax.random, "key_data")
                                            else k))


@pytest.mark.parametrize("seed", [0, 1, 3, 12345, 2 ** 31 - 1])
def test_threefry_primitives_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = TD.prng_key(seed)
    assert _key_data(jk) == tuple(int(v) for v in tk)
    for data in (0, 1, 7, 1000, 2 ** 31 - 5):
        assert _key_data(jax.random.fold_in(jk, data)) == \
            tuple(int(v) for v in TD.fold_in(tk, data))
    for (a, b) in zip(jax.random.split(jk), TD.split(tk)):
        assert _key_data(a) == tuple(int(v) for v in b)
    np.testing.assert_array_equal(
        TD.random_bits(tk, (5, 7)),
        np.asarray(jax.random.bits(jk, (5, 7), jnp.uint32)))


@pytest.mark.parametrize("vocab", [512, 128256, 50280, 7, 2 ** 31 - 1])
def test_tokens_equal_jax_bit_for_bit(vocab):
    for seed in range(4):
        jd = JDataset(JDataConfig(vocab=vocab, seq=33, global_batch=3,
                                  seed=seed))
        td = TD.SyntheticDataset(TD.DataConfig(vocab=vocab, seq=33,
                                               global_batch=3, seed=seed),
                                 device="cpu")
        for step in (0, 1, 7, 1000):
            jb, tb = jd.batch_at(step), td.batch_at(step)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == torch.int32
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))


def test_randint_ranges_equal_jax():
    key = jax.random.PRNGKey(9)
    for lo, hi in ((0, 1), (-5, 5), (3, 2 ** 20 + 7), (-2 ** 31, 2 ** 31 - 1)):
        np.testing.assert_array_equal(
            TD.randint(TD.prng_key(9), (4, 50), lo, hi),
            np.asarray(jax.random.randint(key, (4, 50), lo, hi, jnp.int32)))


def test_labels_are_next_tokens_and_resume():
    cfg = TD.DataConfig(vocab=512, seq=32, global_batch=4, seed=0)
    ds = TD.SyntheticDataset(cfg, device="cpu")
    b = ds.batch_at(7)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    b0, b1 = next(ds), next(ds)
    state = ds.state_dict()
    assert state == {"step": 2, "seed": 0}
    b2 = next(ds)
    ds2 = TD.SyntheticDataset(cfg, device="cpu")
    ds2.load_state_dict(state)
    assert torch.equal(next(ds2)["tokens"], b2["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    with pytest.raises(ValueError, match="seed"):
        TD.SyntheticDataset(TD.DataConfig(512, 32, 4, seed=1),
                            device="cpu").load_state_dict(state)


def test_extras_normals():
    """An extra's draw: float32 normals of its shape, the reference's
    formula (sqrt(2) erfinv(u)) within float32 of jax.random.normal at the
    same key, and a key that is the stable hash of the name."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.normal(jax.random.fold_in(key, 5), (2000,)))
    got = TD.normal(TD.fold_in(TD.prng_key(3), 5), (2000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    ds = TD.SyntheticDataset(TD.DataConfig(512, 8, 2), device="cpu")
    b = ds.batch_at(4, extras={"frames": (2, 6, 3), "vis_embed": (2, 4)})
    assert b["frames"].shape == (2, 6, 3) and b["frames"].dtype == \
        torch.float32
    assert not torch.equal(b["frames"].flatten()[:8],
                           b["vis_embed"].flatten())
    assert 0 <= TD.stable_hash("frames") < 2 ** 31


_DRAW = ("import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.runtime import data as TD; "
         "ds = TD.SyntheticDataset(TD.DataConfig(512, 8, 2), device='cpu'); "
         "print(ds.batch_at(3, extras={'frames': (2, 5)})['frames']"
         ".flatten().tolist()); print(TD.stable_hash('frames'))")
_REF_HASH = "print(hash('frames') % 2 ** 31)"


def _run(code, hashseed):
    env = dict(os.environ, PYTHONHASHSEED=str(hashseed), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, check=True).stdout


def test_c21_extras_are_the_same_in_every_process():
    """ROADMAP C21: the reference folds ``hash(name) % 2**31`` into an
    extra's key, and ``hash`` of a str is salted per process (two salts,
    two keys); the port's extras are the same in two processes with
    different salts."""
    assert _run(_REF_HASH, 1) != _run(_REF_HASH, 2)
    assert _run(_DRAW, 1) == _run(_DRAW, 2)
