"""The port's AdamW, schedule and int8 gradient compression
(``repro_torch.runtime.optimizer``) against the reference's
(``repro/runtime/optimizer.py``) on the CPU, as the reference runs them:
jitted (its train step is one jitted program, where XLA turns ``amax /
127.0`` and ``step / warmup`` into multiplies by float32 reciprocals,
ROADMAP C4, and contracts the schedule's cosine term into an FMA).

``schedule`` and the learning rate equal the reference's bit for bit;
``quantize_int8`` gives the same codes and scales and ``compress_grads``
the same dequantised gradients and residuals over 20 steps;
``apply_updates`` runs ten steps with params, moments and residuals
within 1e-5 of each leaf's largest magnitude (float32 elementwise
arithmetic that XLA fuses and contracts in another grouping: observed up
to 1.0e-6, on the second moment of compressed gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import optimizer as JO

from repro_torch.runtime import optimizer as TO

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

CFGS = [dict(lr=1e-3, warmup_steps=2, total_steps=50),
        dict(),
        dict(lr=3e-4, warmup_steps=7, total_steps=1000, min_lr_frac=0.05),
        dict(lr=2e-2, warmup_steps=0, total_steps=10)]


@pytest.mark.parametrize("kw", CFGS)
def test_schedule_equals_jax_bit_for_bit(kw):
    jcfg, tcfg = JO.OptConfig(**kw), TO.OptConfig(**kw)
    f = jax.jit(lambda c: JO.schedule(jcfg, c))
    steps = list(range(0, 130)) + [499, 500, 501, 999, 1000, 1001, 5000]
    got = np.float32([TO.schedule(tcfg, s) for s in steps])
    want = np.float32([np.asarray(f(jnp.asarray(s, jnp.int32)))
                       for s in steps])
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_bias_corrections_equal_jax():
    f = jax.jit(lambda c, b: 1 - b ** c.astype(jnp.float32),
                static_argnums=1)
    for b in (0.9, 0.95, 0.999):
        for n in list(range(1, 200)) + [1000, 2999]:
            want = np.asarray(f(jnp.asarray(n, jnp.int32), b))
            assert np.float32(TO._bias_correction(b, n)) == want, (b, n)


def _grads(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale * rng.uniform(0.1, 10))
            .astype(np.float32) for k, s in shapes.items()}


SHAPES = {"a": (64, 32), "b": (300,), "c": (7, 5, 3)}


def test_quantize_int8_codes_and_scales_exact():
    rng = np.random.default_rng(0)
    f = jax.jit(JO.quantize_int8)
    for i in range(200):
        g = (rng.standard_normal((1, 7, 300, 499)[i % 4])
             * rng.uniform(1e-5, 50)).astype(np.float32)
        if i % 7 == 0:
            g[rng.integers(0, g.size)] = 0.5 * np.abs(g).max()  # ties
        q, s = TO.quantize_int8(torch.from_numpy(g))
        jq, js = f(jnp.asarray(g))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s) == np.asarray(js)
    z = TO.quantize_int8(torch.zeros(5))
    assert not z[0].any() and float(z[1]) == float(np.float32(1e-12)
                                                   * np.float32(1 / 127))


def test_compress_grads_over_steps():
    """Error feedback carried over 20 steps: the dequantised gradients
    and the residuals (``g - q * scale``, one FMA in both) equal the
    reference's."""
    rng = np.random.default_rng(1)
    f = jax.jit(JO.compress_grads)
    terr = {k: torch.zeros(s) for k, s in SHAPES.items()}
    jerr = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    for _ in range(20):
        g = _grads(rng, SHAPES)
        tdeq, terr = TO.compress_grads({k: torch.from_numpy(v)
                                        for k, v in g.items()}, terr)
        jdeq, jerr = f({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        for k in SHAPES:
            np.testing.assert_array_equal(tdeq[k].numpy(),
                                          np.asarray(jdeq[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))


def test_global_norm():
    rng = np.random.default_rng(2)
    g = _grads(rng, SHAPES)
    got = float(TO.global_norm({k: torch.from_numpy(v)
                                for k, v in g.items()}))
    want = float(JO.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("kw", CFGS[:2])
def test_apply_updates_over_steps(kw, compress):
    """Ten AdamW steps (clipping active in some) from the same params:
    params, moments, residuals, count and the metrics."""
    rng = np.random.default_rng(3)
    kw = dict(kw, grad_compress=compress, clip_norm=5.0)
    jcfg, tcfg = JO.OptConfig(**kw), TO.OptConfig(**kw)
    p0 = _grads(rng, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js, ts = JO.init_opt(jp, jcfg), TO.init_opt(tp, tcfg)
    step = jax.jit(lambda p, g, s: JO.apply_updates(p, g, s, jcfg))
    for i in range(10):
        g = _grads(rng, SHAPES, scale=0.5 if i % 2 else 3.0)
        jp, js, jm = step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts, tm = TO.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tcfg)
        assert np.float32(tm["lr"]) == np.asarray(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-6 * float(jm["grad_norm"])
        assert int(ts.count) == int(js.count) == i + 1
        for k in SHAPES:
            for what, got, want in (("p", tp[k], jp[k]),
                                    ("mu", ts.mu[k], js.mu[k]),
                                    ("nu", ts.nu[k], js.nu[k]),
                                    ("err", ts.err[k], js.err[k])):
                want = np.asarray(want)
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(got.numpy() - want).max()) \
                    <= 1e-5 * scale, (i, k, what)


def test_init_opt_matches_the_reference_structure():
    p = {"w": torch.ones(3, 4), "n": [torch.ones(2)]}
    s = TO.init_opt(p, TO.OptConfig())
    assert s.err["w"].shape == () and s.mu["w"].shape == (3, 4)
    s = TO.init_opt(p, TO.OptConfig(grad_compress=True))
    assert s.err["n"][0].shape == (2,)
    assert s.count.dtype == torch.int32 and int(s.count) == 0
    # functional: the inputs stay as they were
    g = {"w": torch.full((3, 4), 0.5), "n": [torch.ones(2)]}
    before = p["w"].clone()
    TO.apply_updates(p, g, s, TO.OptConfig(grad_compress=True))
    assert torch.equal(p["w"], before) and not s.mu["w"].any()
