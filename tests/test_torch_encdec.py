"""The port's encoder-decoder serving path (whisper-small) against the JAX
reference on the CPU.

whisper-small's SMOKE config (2 encoder and 2 decoder layers, d 64, 4
heads of 16, 32 frames) in f32, with the same weights, tokens and frame
embeddings in both packages: ``torch_lm_weights`` draws them from a numpy
seed in the reference's layout and the port takes the weights through
``lm_params_from_jax``.  Cross-attention (``apply_attention`` with
``cross_kv``, with and without ``qk_norm``), ``encode``, the prefill for
each attention implementation (the port's pallas through the kernel's
plain version, the reference's through its Pallas kernel in interpret
mode), the teacher-forced decode with the cache's ``enc_out`` zero and
assigned, ``greedy_generate``'s tokens and the committed serve reference
are held against the reference's.

The reference's chunked attention is held where no chunk is ragged
(chunks of 4 over 12 tokens and 32 frames): a ragged chunk's padding is
attended by a non-causal call there (ROADMAP C19, pinned below).  Its
decode never fills ``enc_out`` (ROADMAP C20, pinned below).

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
from repro.models import layers as JLay
from repro.models import lm as JL
from repro.runtime import serve as JS

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as TLay
from repro_torch.models import lm as TL
from repro_torch.runtime import serve as TS

from torch_lm_weights import MM_SERVE_REF, frames, lm_weights, prompt
from torch_parity import (MM_SERVE_REF_PATHS, jax_greedy, jax_teacher_forced,
                          mm_smoke_serve_reference, port_decode)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

ARCH = "whisper-small"
IMPLS = ["naive", "chunked", "pallas"]
B, T = 2, 12
#: Chunks that divide the 12 tokens and the 32 frames: no padding.
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
def _params(dtype="float32", qk_norm=False):
    """(reference params, port params on the CPU) from seed 0."""
    cfg, tcfg = _cfgs(dtype, qk_norm=qk_norm)
    w = lm_weights(cfg, 0)
    return (jax.tree.map(jnp.asarray, w),
            lm_params_from_jax(w, tcfg, device="cpu"))


def _inputs(n=T):
    cfg = j_get_config(ARCH, smoke=True)
    return prompt(cfg, 0, B, n), frames(cfg, 0, B)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _prefills(impl, dtype="float32"):
    """(reference, port) prefill logits of the prompt with its frames."""
    cfg, tcfg = _cfgs(dtype, attn_impl=impl)
    jp, tp = _params(dtype)
    toks, fr = _inputs()
    want = jax.jit(JS.make_prefill_step(cfg))(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})
    got = TS.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(fr)})
    return np.asarray(want, np.float32), got


# --------------------------------------------------------------------------- #
# init, cross-attention and the encoder
# --------------------------------------------------------------------------- #

def test_init_params_and_cache_shapes_and_types():
    cfg, tcfg = _cfgs("bfloat16")
    want = jax.eval_shape(lambda k: JL.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    got = TL.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(want)
    assert len(got["enc_layers"]) == cfg.n_enc_layers == 2
    assert len(got["layers"]) == cfg.n_layers
    for stack in ("enc_layers", "layers"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                want[stack])[0]:
            keys = [p.key for p in path]
            t = functools.reduce(lambda d, k: d[k], keys, got[stack][1])
            assert tuple(t.shape) == leaf.shape[1:], (stack, keys)
            norm = keys[-1] in ("ln1", "ln2", "ln_x")
            assert t.dtype == (torch.float32 if norm else torch.bfloat16)
    assert "xattn" in got["layers"][0] and "xattn" not in got["enc_layers"][0]
    assert got["enc_norm"].dtype == torch.float32
    jc = JL.init_cache(cfg, B, 8)
    tc = TL.init_cache(tcfg, B, 8, device="cpu")
    assert tuple(tc["enc_out"].shape) == jc["enc_out"].shape == (B, 32, 64)
    assert tc["enc_out"].dtype == torch.bfloat16 and not tc["enc_out"].any()
    assert len(tc["layers"]) == cfg.n_layers
    # the weights carried across keep their norms in f32
    _, tp = _params()
    assert tp["layers"][0]["ln_x"].dtype == tp["enc_norm"].dtype \
        == torch.float32


@pytest.mark.parametrize("impl, Tq", [
    ("naive", T), ("chunked", T), ("pallas", T), ("naive", 1),
    ("pallas", 1)])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_jax(impl, Tq, qk_norm):
    """Decoder queries (12, or one in decode) against 32 encoder keys,
    non-causal, no RoPE.  With ``qk_norm`` q is normed and k is not: a
    ``k_norm`` set to anything leaves the output as it is."""
    cfg, tcfg = _cfgs(attn_impl=impl, qk_norm=qk_norm)
    jp, tp = _params(qk_norm=qk_norm)
    jlp, tx = jax.tree.map(lambda a: a[1], jp["layers"]), tp["layers"][1]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, Tq, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((B, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(Tq, dtype=np.int32) + 7, (B, Tq)).copy()
    jkv = JL._cross_kv(jlp, jnp.asarray(enc), cfg)
    tkv = TL._cross_kv(tx, torch.from_numpy(enc), tcfg)
    for a, b in zip(tkv, jkv):
        _close(a, b, F32_TOL)
    want, _ = JLay.apply_attention(jlp["xattn"], jnp.asarray(x), cfg,
                                   positions=jnp.asarray(pos), causal=False,
                                   cross_kv=jkv)
    got, cache = TLay.apply_attention(tx["xattn"], torch.from_numpy(x), tcfg,
                                      positions=torch.from_numpy(pos),
                                      causal=False, cross_kv=tkv)
    assert cache is None and got.shape == (B, Tq, cfg.d_model)
    _close(got, want, F32_TOL)
    if qk_norm:
        odd = dict(tx["xattn"], k_norm=tx["xattn"]["k_norm"] * 3.0)
        again, _ = TLay.apply_attention(odd, torch.from_numpy(x), tcfg,
                                        positions=torch.from_numpy(pos),
                                        causal=False, cross_kv=tkv)
        assert torch.equal(again, got)
        odd = dict(tx["xattn"], q_norm=tx["xattn"]["q_norm"] * 3.0)
        moved, _ = TLay.apply_attention(odd, torch.from_numpy(x), tcfg,
                                        positions=torch.from_numpy(pos),
                                        causal=False, cross_kv=tkv)
        assert float((moved - got).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(impl):
    """The non-causal encoder over 32 frames (chunked: 8 chunks of 4)."""
    cfg, tcfg = _cfgs(attn_impl=impl)
    jp, tp = _params()
    _, fr = _inputs()
    want = JL.encode(jp, jnp.asarray(fr), cfg)
    got = TL.encode(tp, torch.from_numpy(fr), tcfg)
    assert got.shape == (B, cfg.enc_seq, cfg.d_model)
    _close(got, want, F32_TOL)
    # non-causal: the first frame's output depends on the last frame
    fr2 = fr.copy()
    fr2[:, -1] += 1.0
    moved = TL.encode(tp, torch.from_numpy(fr2), tcfg)
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-3


# --------------------------------------------------------------------------- #
# the serve steps
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_match_jax(impl):
    want, got = _prefills(impl)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, F32_TOL)


def test_bf16_prefill_logits_match_jax():
    want, got = _prefills("naive", "bfloat16")
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_LOGIT_SHARE * np.abs(want).max())


def test_prefill_depends_on_the_frames():
    """Not vacuous: zero frames move the logits (the encoder's output goes
    through every decoder layer's cross-attention)."""
    _, tcfg = _cfgs(attn_impl="pallas")
    _, tp = _params()
    toks, fr = _inputs()
    prefill = TS.make_prefill_step(tcfg, device="cpu")
    a = prefill(tp, {"tokens": torch.from_numpy(toks),
                     "frames": torch.from_numpy(fr)})
    b = prefill(tp, {"tokens": torch.from_numpy(toks),
                     "frames": torch.zeros(fr.shape)})
    assert float((a - b).norm() / a.norm()) > 0.05


@pytest.mark.parametrize("assigned", [False, True])
def test_teacher_forced_decode_matches_jax(assigned):
    """Every prompt step from an f32 cache, the cross K/V computed anew
    from ``enc_out`` at each step: zero (the reference's own ``enc_out``,
    ROADMAP C20) or assigned from ``encode``.  The port's naive and pallas
    decode (the self-attention at ``q_offset = pos``, the cross-attention
    one query against 32 keys) against the reference's naive decode (its
    pallas decode is ROADMAP C6)."""
    cfg, tcfg = _cfgs(attn_impl="naive")
    jp, tp = _params()
    toks, fr = _inputs()
    j_enc = t_enc = None
    if assigned:
        j_enc = JL.encode(jp, jnp.asarray(fr), cfg)
        t_enc = TL.encode(tp, torch.from_numpy(fr), tcfg)
    want = jax_teacher_forced(cfg, jp, toks, jnp.float32, enc_out=j_enc)
    for impl in ("naive", "pallas"):
        got = port_decode(dataclasses.replace(tcfg, attn_impl=impl), tp,
                           toks, T, t_enc)
        _close(got, want, F32_TOL)


def test_greedy_generate_tokens_match_jax():
    """``greedy_generate`` (a fresh bf16 cache: zero ``enc_out``) gives the
    reference's ``greedy_generate`` tokens, and the tokens of a
    step-by-step decode from a bf16 cache; from an f32 cache the port's
    steps give the reference's, with ``enc_out`` zero or assigned."""
    cfg, tcfg = _cfgs(attn_impl="naive")
    jp, tp = _params()
    toks, fr = _inputs()
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
    j_enc = JL.encode(jp, jnp.asarray(fr), cfg)
    t_enc = TL.encode(tp, torch.from_numpy(fr), tcfg)
    for j, t in ((None, None), (j_enc, t_enc)):
        np.testing.assert_array_equal(
            port_decode(tcfg, tp, toks, T + new, t, new),
            jax_greedy(cfg, jp, toks, new, enc_out=j))


# --------------------------------------------------------------------------- #
# ROADMAP C19 and C20: faults of the reference, not carried over
# --------------------------------------------------------------------------- #

def test_c19_reference_chunked_non_causal_attends_its_padding():
    """Chunks of 12 over 32 frames: the reference pads the last chunk with
    4 zero keys at position -10**9, which no mask removes in a non-causal
    call, so its chunked encoder and cross-attention prefill move from its
    naive ones.  The port's chunked path slices the last chunk and equals
    the reference's naive run.  Documents the reference fault; does not
    fix it."""
    cfg, tcfg = _cfgs(attn_impl="chunked", attn_chunk=12)
    naive = dataclasses.replace(cfg, attn_impl="naive")
    jp, tp = _params()
    toks, fr = _inputs()
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    ref_enc = np.asarray(JL.encode(jp, jnp.asarray(fr), cfg))
    want_enc = np.asarray(JL.encode(jp, jnp.asarray(fr), naive))
    assert np.abs(ref_enc - want_enc).max() > 0.05
    ref_pre = np.asarray(JS.make_prefill_step(cfg)(jp, jb))
    want_pre = np.asarray(JS.make_prefill_step(naive)(jp, jb))
    assert np.abs(ref_pre - want_pre).max() > 0.1
    _close(TL.encode(tp, torch.from_numpy(fr), tcfg), want_enc, F32_TOL)
    got = TS.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(fr)})
    _close(got, want_pre, F32_TOL)


def test_c20_reference_decode_cross_attends_a_zero_encoder_output():
    """Nothing in the reference fills the cache's ``enc_out``, so its
    decode cross-attends zeros and its last prompt step moves from its
    prefill by O(1).  With ``enc_out`` assigned from ``encode`` the decode
    of both packages equals the reference's prefill.  Documents the
    reference fault; the port keeps the reference's interface."""
    cfg, tcfg = _cfgs(attn_impl="naive")
    jp, tp = _params()
    toks, fr = _inputs()
    pre = np.asarray(JS.make_prefill_step(cfg)(
        jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}))
    zero = jax_teacher_forced(cfg, jp, toks, jnp.float32)
    assert np.abs(zero[-1] - pre).max() > 1.0
    j_enc = JL.encode(jp, jnp.asarray(fr), cfg)
    _close(jax_teacher_forced(cfg, jp, toks, jnp.float32, enc_out=j_enc)[-1],
           pre, F32_TOL)
    t_enc = TL.encode(tp, torch.from_numpy(fr), tcfg)
    for impl in ("naive", "pallas"):
        got = port_decode(dataclasses.replace(tcfg, attn_impl=impl), tp,
                           toks, T, t_enc)
        _close(got[-1], pre, F32_TOL)


# --------------------------------------------------------------------------- #
# the committed serve reference (checked on the card by chip_smoke.py)
# --------------------------------------------------------------------------- #

def test_whisper_smoke_serve_reference_file_is_what_jax_computes():
    ref = json.loads(MM_SERVE_REF_PATHS[ARCH].read_text())
    assert {k: ref[k] for k in MM_SERVE_REF[ARCH]} == MM_SERVE_REF[ARCH]
    want = mm_smoke_serve_reference(ARCH)
    assert ref.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list) and k != "prompt" and "greedy" not in k:
            np.testing.assert_allclose(ref[k], v, rtol=1e-6, atol=1e-6)
        else:
            assert ref[k] == v, k


def test_port_matches_the_whisper_serve_reference_on_cpu():
    """What chip_smoke.py checks on the card, here on the CPU: the pallas
    prefill, the pallas decode of every prompt step and the greedy tokens
    from an f32 cache, with ``enc_out`` zero and assigned, at 1e-4."""
    ref = json.loads(MM_SERVE_REF_PATHS[ARCH].read_text())
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype="float32", attn_impl="pallas")
    tp = lm_params_from_jax(lm_weights(tcfg, ref["seed"]), tcfg,
                            device="cpu")
    toks = np.asarray(ref["prompt"], np.int32)
    fr = torch.from_numpy(frames(tcfg, ref["seed"], ref["batch"]))
    got = TS.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks), "frames": fr})
    _close(got, np.reshape(ref["prefill_last_logits"], got.shape), 1e-4)
    enc = TL.encode(tp, fr, tcfg)
    n = ref["steps"] + ref["new"]
    for suffix, e in (("", None), ("_enc_out", enc)):
        got = port_decode(tcfg, tp, toks, ref["steps"], e)
        _close(got, np.reshape(ref["decode_logits_f32_cache" + suffix],
                               got.shape), 1e-4)
        assert port_decode(tcfg, tp, toks, n, e, ref["new"]).tolist() \
            == ref["greedy_tokens" + suffix]
