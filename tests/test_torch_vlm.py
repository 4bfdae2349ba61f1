"""The port's vision-language serving path (internvl2-26b) against the JAX
reference on the CPU.

internvl2-26b's SMOKE config (the dense backbone: 2 layers, d 64, 4/1
heads of 16, 8 patch embeddings) in f32, with the same weights, tokens
and patch embeddings in both packages: ``torch_lm_weights`` draws them
from a numpy seed in the reference's layout and the port takes the
weights through ``lm_params_from_jax``.  The prefill (patch embeddings
ahead of the tokens, causal over the whole row) for each attention
implementation (the port's pallas through the kernel's plain version, the
reference's through its Pallas kernel in interpret mode), the text-only
decode (the reference's prefill returns no cache, so its decode never
sees the image), ``greedy_generate``'s tokens and the committed serve
reference are held against the reference's.

Chunked attention in chunks of 4, which divide the 20 rows (8 patches and
12 tokens): a ragged causal chunk is ROADMAP C7 in the reference.

Tolerances.  f32: 1e-5 (summation order and libm ulps).  bf16 logits: 5%
of the largest logit, as for the dense models (tests/test_torch_lm.py).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as JL
from repro.runtime import serve as JS

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm as TL
from repro_torch.runtime import serve as TS

from torch_lm_weights import MM_SERVE_REF, lm_weights, prompt, vis_embed
from torch_parity import (MM_SERVE_REF_PATHS, jax_greedy, jax_teacher_forced,
                          mm_smoke_serve_reference, port_decode)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

ARCH = "internvl2-26b"
IMPLS = ["naive", "chunked", "pallas"]
B, T = 2, 12
CHUNK = 4
F32_TOL = 1e-5
BF16_LOGIT_SHARE = 0.05


def _cfgs(dtype="float32", **over):
    """(reference config, port config): the SMOKE config in ``dtype``."""
    over = dict(dict(attn_chunk=CHUNK), **over)
    return (dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype,
                                **over),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                                **over))


@functools.lru_cache(maxsize=None)
def _params(dtype="float32"):
    """(reference params, port params on the CPU) from seed 0."""
    cfg, tcfg = _cfgs(dtype)
    w = lm_weights(cfg, 0)
    return (jax.tree.map(jnp.asarray, w),
            lm_params_from_jax(w, tcfg, device="cpu"))


def _inputs(n=T):
    cfg = j_get_config(ARCH, smoke=True)
    return prompt(cfg, 0, B, n), vis_embed(cfg, 0, B)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _port_prefill(tcfg, tp, toks, vis):
    return TS.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks),
             "vis_embed": torch.as_tensor(vis)})


# --------------------------------------------------------------------------- #
# init and the serve steps
# --------------------------------------------------------------------------- #

def test_init_params_and_cache_are_the_dense_models():
    cfg, tcfg = _cfgs("bfloat16")
    want = jax.eval_shape(lambda k: JL.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    got = TL.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(want) and len(got["layers"]) == cfg.n_layers
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            want["layers"])[0]:
        keys = [p.key for p in path]
        t = functools.reduce(lambda d, k: d[k], keys, got["layers"][1])
        assert tuple(t.shape) == leaf.shape[1:], keys
    assert sorted(got["layers"][0]) == ["attn", "ln1", "ln2", "mlp"]
    jc = JL.init_cache(cfg, B, 8)
    tc = TL.init_cache(tcfg, B, 8, device="cpu")
    assert sorted(tc) == sorted(jc) == ["layers"]
    assert tuple(tc["layers"][0]["k"].shape) == jc["layers"]["k"].shape[1:]


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_with_patch_embeddings_matches_jax(impl):
    """8 patch embeddings ahead of 12 tokens: the hidden states of every
    row (``forward_hidden`` over the concatenation) and the prefill's
    last-position logits."""
    cfg, tcfg = _cfgs(attn_impl=impl)
    jp, tp = _params()
    toks, vis = _inputs()
    want = jax.jit(JS.make_prefill_step(cfg))(
        jp, {"tokens": jnp.asarray(toks), "vis_embed": jnp.asarray(vis)})
    got = _port_prefill(tcfg, tp, toks, vis)
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
    _close(got, want, F32_TOL)
    n = cfg.n_vis_tokens + T
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (B, n)).copy()
    jx = jnp.concatenate([jnp.asarray(vis), JL.embed_tokens(
        jp, jnp.asarray(toks), cfg)], axis=1)
    tx = torch.cat([torch.from_numpy(vis), TL.embed_tokens(
        tp, torch.from_numpy(toks), tcfg)], dim=1)
    want, _ = JL.forward_hidden(jp, jx, jnp.asarray(pos), cfg)
    got, _ = TL.forward_hidden(tp, tx, torch.from_numpy(pos), tcfg)
    _close(got, want, F32_TOL)


def test_bf16_prefill_logits_match_jax():
    cfg, tcfg = _cfgs("bfloat16", attn_impl="naive")
    jp, tp = _params("bfloat16")
    toks, vis = _inputs()
    want = np.asarray(JS.make_prefill_step(cfg)(
        jp, {"tokens": jnp.asarray(toks), "vis_embed": jnp.asarray(vis)}),
        np.float32)
    got = _port_prefill(tcfg, tp, toks, vis)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_LOGIT_SHARE * np.abs(want).max())


def test_prefill_depends_on_the_patch_embeddings():
    """Not vacuous: zero patches move the logits; and the prefill without
    patches is the text-only dense prefill the decode is held against."""
    _, tcfg = _cfgs(attn_impl="pallas")
    _, tp = _params()
    toks, vis = _inputs()
    a = _port_prefill(tcfg, tp, toks, vis)
    b = _port_prefill(tcfg, tp, toks, np.zeros_like(vis))
    assert float((a - b).norm() / a.norm()) > 0.05
    text = _port_prefill(tcfg, tp, toks, vis[:, :0])
    dense = dataclasses.replace(tcfg, kind="dense")
    _close(text, TS.make_prefill_step(dense, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)}), 0.0)


def test_text_decode_matches_jax_and_the_text_prefill():
    """Every prompt step from an f32 cache, text alone (the reference's
    prefill returns no cache, ROADMAP C20): the port's naive and pallas
    decode against the reference's naive decode (its pallas decode is
    ROADMAP C6), and the last step against a prefill without patches."""
    cfg, tcfg = _cfgs(attn_impl="naive")
    jp, tp = _params()
    toks, vis = _inputs()
    want = jax_teacher_forced(cfg, jp, toks, jnp.float32)
    for impl in ("naive", "pallas"):
        c = dataclasses.replace(tcfg, attn_impl=impl)
        got = port_decode(c, tp, toks, T)
        _close(got, want, F32_TOL)
        _close(got[-1], _port_prefill(c, tp, toks, vis[:, :0]), F32_TOL)


def test_greedy_generate_tokens_match_jax():
    """``greedy_generate`` (a fresh bf16 cache) gives the reference's
    ``greedy_generate`` tokens and those of a step-by-step decode from a
    bf16 cache; from an f32 cache the port's steps give the reference's."""
    cfg, tcfg = _cfgs(attn_impl="naive")
    jp, tp = _params()
    toks, _ = _inputs()
    new = 4
    want = JS.greedy_generate(jp, cfg, jnp.asarray(toks), new, T + new)
    for impl in ("naive", "pallas"):
        c = dataclasses.replace(tcfg, attn_impl=impl)
        gen = TS.greedy_generate(tp, c, torch.from_numpy(toks), new, T + new,
                                 device="cpu")
        assert gen.dtype == torch.int32
        np.testing.assert_array_equal(gen.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            gen.numpy(), port_decode(c, tp, toks, T + new, new=new,
                                      cache_dtype=torch.bfloat16))
    np.testing.assert_array_equal(
        port_decode(tcfg, tp, toks, T + new, new=new),
        jax_greedy(cfg, jp, toks, new))


# --------------------------------------------------------------------------- #
# the committed serve reference (checked on the card by chip_smoke.py)
# --------------------------------------------------------------------------- #

def test_internvl2_smoke_serve_reference_file_is_what_jax_computes():
    ref = json.loads(MM_SERVE_REF_PATHS[ARCH].read_text())
    assert {k: ref[k] for k in MM_SERVE_REF[ARCH]} == MM_SERVE_REF[ARCH]
    want = mm_smoke_serve_reference(ARCH)
    assert ref.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list) and k not in ("prompt", "greedy_tokens"):
            np.testing.assert_allclose(ref[k], v, rtol=1e-6, atol=1e-6)
        else:
            assert ref[k] == v, k


def test_port_matches_the_internvl2_serve_reference_on_cpu():
    """What chip_smoke.py checks on the card, here on the CPU: the pallas
    prefill with the patch embeddings, the pallas decode of every prompt
    step and the greedy tokens from an f32 cache, at 1e-4."""
    ref = json.loads(MM_SERVE_REF_PATHS[ARCH].read_text())
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype="float32", attn_impl="pallas")
    tp = lm_params_from_jax(lm_weights(tcfg, ref["seed"]), tcfg,
                            device="cpu")
    toks = np.asarray(ref["prompt"], np.int32)
    got = _port_prefill(tcfg, tp, toks,
                        vis_embed(tcfg, ref["seed"], ref["batch"]))
    _close(got, np.reshape(ref["prefill_last_logits"], got.shape), 1e-4)
    got = port_decode(tcfg, tp, toks, ref["steps"])
    _close(got, np.reshape(ref["decode_logits_f32_cache"], got.shape), 1e-4)
    assert port_decode(tcfg, tp, toks, ref["steps"] + ref["new"],
                        new=ref["new"]).tolist() == ref["greedy_tokens"]
