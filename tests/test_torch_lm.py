"""The port's dense-LM serving path against the JAX reference on the CPU.

SMOKE configs of llama3-8b (GQA 4:1) and qwen3-4b (qk_norm, tied
embeddings), in f32 and bf16, with the same weights in both packages:
``torch_lm_weights`` draws them from a numpy seed in the reference's
layout, and the port takes them through ``lm_params_from_jax``.  The
layers (``rms_norm``, ``apply_rope``, ``apply_mlp``, ``apply_attention``
with each of naive / chunked / pallas), ``forward_hidden``, prefill
logits, teacher-forced decode logits and greedy tokens are held against
the reference's, each attention implementation against its own
counterpart (the pallas path against the reference's Pallas kernel in
interpret mode).

Tolerances.  f32: 1e-5 (summation order and libm ulps).  bf16 layers:
2e-2, one or two bf16 roundings (2^-8) apart.  bf16 logits: 5% of the
largest logit: the packages round to bf16 at other points (XLA keeps a
fused elementwise chain in f32, PyTorch rounds after each op) and the
differences compound over the layers; the greedy tokens still agree.  An
f32 model decodes against a bf16 cache by default (as in the reference):
there a cached k/v value or a probability can round to the other bf16
neighbour in the two packages, so those logits are held to 2e-2.
"""
import dataclasses
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JLay
from repro.models import lm as JL
from repro.models.config import ModelConfig as JModelConfig
from repro.runtime import serve as JS

import repro_torch
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TLay
from repro_torch.models import lm as TL
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import serve as TS

from torch_lm_weights import lm_weights, prompt
from torch_parity import (SERVE_REF_PATH, jax_teacher_forced,
                          llama3_smoke_serve_reference)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ["llama3-8b", "qwen3-4b"]
DTYPES = ["float32", "bfloat16"]
B, T = 2, 16
F32_TOL = 1e-5
BF16_LAYER_TOL = 2e-2
BF16_LOGIT_SHARE = 0.05
BF16_CACHE_TOL = 2e-2


def _cfgs(arch, dtype, **over):
    """(reference config, port config): the SMOKE config in ``dtype``."""
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype,
                                **over),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                                **over))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """(reference params, port params on the CPU) from seed 0."""
    cfg, tcfg = _cfgs(arch, dtype)
    w = lm_weights(cfg, 0)
    return (jax.tree.map(jnp.asarray, w),
            lm_params_from_jax(w, tcfg, device="cpu"))


def _tokens(arch, n=T):
    return prompt(j_get_config(arch, smoke=True), 0, B, n)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _close_logits(got, want, dtype):
    want = np.asarray(want, np.float32)
    tol = F32_TOL if dtype == "float32" else \
        BF16_LOGIT_SHARE * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol)


def _rand(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _port_decode(tcfg, params, tokens, cache_dtype):
    cache = TL.init_cache(tcfg, tokens.shape[0], tokens.shape[1],
                          dtype=cache_dtype, device="cpu")
    step = TS.make_decode_step(tcfg, device="cpu")
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = step(params, cache,
                             torch.from_numpy(tokens[:, t:t + 1]), t)
        out.append(logits.numpy())
    return np.stack(out)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #

def test_configs_are_the_references_field_for_field():
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JModelConfig)]
    for arch in ARCHS:
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke)) == \
                dataclasses.asdict(j_get_config(arch, smoke)), (arch, smoke)
    assert get_config("llama3-8b").attn_impl == "chunked"


def test_init_params_shapes_types_and_scales():
    """init_params: the reference's tree with layers unstacked, matrices in
    cfg.dtype and norms in f32, drawn with the reference's scales."""
    for arch in LM_ARCHS:
        cfg, tcfg = _cfgs(arch, "bfloat16")
        want = jax.eval_shape(lambda k: JL.init_params(k, cfg),
                              jax.random.PRNGKey(0))
        got = TL.init_params(torch.Generator().manual_seed(0), tcfg)
        assert sorted(got) == sorted(want)
        for name in ("embed", "final_norm", "lm_head"):
            if name in want:
                assert tuple(got[name].shape) == want[name].shape
        assert len(got["layers"]) == cfg.n_layers
        flat_w = jax.tree_util.tree_flatten_with_path(want["layers"])[0]
        for path, leaf in flat_w:
            keys = [p.key for p in path]
            t = functools.reduce(lambda d, k: d[k], keys, got["layers"][1])
            assert tuple(t.shape) == leaf.shape[1:], keys
            norm = keys[-1] in ("ln1", "ln2", "q_norm", "k_norm")
            assert t.dtype == (torch.float32 if norm else torch.bfloat16)
        wq = got["layers"][0]["attn"]["wq"].float()
        assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 0.1
        assert abs(float(got["embed"].float().std()) / 0.02 - 1) < 0.1


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rms_norm_rope_and_mlp_match_jax(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_LAYER_TOL
    jx, tx = _rand(1, (B, T, cfg.d_model), dtype)
    _close(TLay.rms_norm(tx, tp["layers"][0]["ln1"], cfg.norm_eps),
           JLay.rms_norm(jx, jp["layers"]["ln1"][0], cfg.norm_eps), tol)
    pos = np.broadcast_to(np.arange(100, 100 + T, dtype=np.int32), (B, T))
    jcos, jsin = JLay.rope_angles(jnp.asarray(pos), cfg.hd, cfg.rope_theta)
    tcos, tsin = TLay.rope_angles(torch.from_numpy(pos.copy()), cfg.hd,
                                  cfg.rope_theta)
    _close(tcos, jcos, F32_TOL)
    _close(tsin, jsin, F32_TOL)
    jh, th = _rand(2, (B, T, cfg.n_heads, cfg.hd), dtype)
    got = TLay.apply_rope(th, tcos, tsin)
    assert got.dtype == th.dtype
    _close(got, JLay.apply_rope(jh, jcos, jsin), tol)
    got = TLay.apply_mlp(tp["layers"][0]["mlp"], tx, tcfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, JLay.apply_mlp(_layer0(jp["layers"]["mlp"]), jx, cfg), tol)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_apply_attention_matches_jax(arch, dtype, impl):
    """Prefill attention of layer 0, each implementation against its own
    reference counterpart (chunked with 8-key chunks over 16 keys)."""
    cfg, tcfg = _cfgs(arch, dtype, attn_impl=impl, attn_chunk=8)
    jp, tp = _params(arch, dtype)
    jx, tx = _rand(3, (B, T, cfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, _ = JLay.apply_attention(_layer0(jp["layers"]["attn"]), jx, cfg,
                                   positions=jnp.asarray(pos))
    got, _ = TLay.apply_attention(tp["layers"][0]["attn"], tx, tcfg,
                                  positions=torch.from_numpy(pos.copy()))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, F32_TOL if dtype == "float32" else BF16_LAYER_TOL)


# --------------------------------------------------------------------------- #
# the model and the serve steps
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_hidden_and_prefill_logits_match_jax(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype, attn_impl="pallas")
    jp, tp = _params(arch, dtype)
    toks = _tokens(arch)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, _ = JL.forward_hidden(jp, JL.embed_tokens(jp, jnp.asarray(toks),
                                                     cfg),
                                jnp.asarray(pos), cfg)
    got, aux = TL.forward_hidden(tp, TL.embed_tokens(
        tp, torch.from_numpy(toks), tcfg), torch.from_numpy(pos.copy()), tcfg)
    assert float(aux) == 0.0 and got.dtype == getattr(torch, dtype)
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    _close(got, want,
           F32_TOL if dtype == "float32" else BF16_LOGIT_SHARE * scale)
    for impl in ("pallas", "naive"):
        c, tc = _cfgs(arch, dtype, attn_impl=impl)
        want = jax.jit(JS.make_prefill_step(c))(
            jp, {"tokens": jnp.asarray(toks)})
        got = TS.make_prefill_step(tc, device="cpu")(
            tp, {"tokens": torch.from_numpy(toks)})
        assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
        _close_logits(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_teacher_forced_decode_logits_match_jax(arch, dtype):
    """Decode from an empty cache, one prompt token a step, every step's
    logits.  The reference's pallas decode is ROADMAP C6, so each port
    implementation is held against the reference's naive decode: with an
    f32 cache (f32 only: the reference cannot decode a bf16 model against
    one) the naive probabilities are not rounded and both port
    implementations match at f32 tolerance; with the default bf16 cache
    the port's naive decode is held to the reference's."""
    cfg, tcfg = _cfgs(arch, dtype, attn_impl="naive")
    jp, tp = _params(arch, dtype)
    toks = _tokens(arch)
    want = jax_teacher_forced(cfg, jp, toks, jnp.bfloat16)
    got = _port_decode(tcfg, tp, toks, torch.bfloat16)
    if dtype == "float32":
        _close(got, want, BF16_CACHE_TOL)
        want = jax_teacher_forced(cfg, jp, toks, jnp.float32)
        for impl in ("naive", "pallas"):
            tc = dataclasses.replace(tcfg, attn_impl=impl)
            _close(_port_decode(tc, tp, toks, torch.float32), want, F32_TOL)
    else:
        _close_logits(got, want, dtype)
        got = _port_decode(dataclasses.replace(tcfg, attn_impl="pallas"), tp,
                           toks, torch.bfloat16)
        _close_logits(got, want, dtype)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_greedy_generate_tokens_match_jax(arch):
    """f32: the port's greedy tokens through the kernel path (and through
    naive attention) equal the reference's through its naive attention."""
    cfg, tcfg = _cfgs(arch, "float32", attn_impl="naive")
    jp, tp = _params(arch, "float32")
    toks = _tokens(arch, 8)
    want = np.asarray(JS.greedy_generate(jp, cfg, jnp.asarray(toks), 8, 16))
    for impl in ("pallas", "naive"):
        got = TS.greedy_generate(tp, dataclasses.replace(tcfg, attn_impl=impl),
                                 torch.from_numpy(toks), 8, 16, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# faults of the reference that the port does not copy (ROADMAP C6, C7)
# --------------------------------------------------------------------------- #

def test_c6_reference_pallas_decode_is_wrong_and_the_port_is_not():
    """ROADMAP C6: the reference's pallas branch drops the decode position
    (no q_offset), so its decode reads cache slot 0 only: it differs from
    its own naive decode and from its own prefill by O(1) logits.  The
    port's pallas decode (q_offset = pos) matches the reference's naive
    decode.  Documents the reference fault; does not fix it."""
    cfg, tcfg = _cfgs("llama3-8b", "float32", attn_impl="naive")
    jp, tp = _params("llama3-8b", "float32")
    toks = _tokens("llama3-8b")
    naive = jax_teacher_forced(cfg, jp, toks, jnp.float32)
    jpallas = dataclasses.replace(cfg, attn_impl="pallas")
    ref_pallas = jax_teacher_forced(jpallas, jp, toks, jnp.float32)
    prefill = np.asarray(jax.jit(JS.make_prefill_step(jpallas))(
        jp, {"tokens": jnp.asarray(toks)}))
    assert np.abs(ref_pallas - naive).max() > 0.5
    assert np.abs(ref_pallas[-1] - prefill).max() > 0.5
    np.testing.assert_allclose(naive[-1], prefill, rtol=F32_TOL, atol=F32_TOL)
    got = _port_decode(dataclasses.replace(tcfg, attn_impl="pallas"), tp,
                       toks, torch.float32)
    _close(got, naive, F32_TOL)


def test_c7_reference_chunked_attends_its_padding_and_the_port_does_not():
    """ROADMAP C7: the reference's chunked attention pads a ragged last
    chunk with keys at position -10**9, which a causal mask lets through
    (zero keys with score 0 dilute every row).  The port masks the padding
    and matches the reference's naive attention, at the layer and in the
    model (12 keys in chunks of 8)."""
    jq, tq = _rand(4, (1, 40, 2, 16), "float32")
    jk, tk = _rand(5, (1, 40, 1, 16), "float32")
    jv, tv = _rand(6, (1, 40, 1, 16), "float32")
    jpos = jnp.broadcast_to(jnp.arange(40, dtype=jnp.int32)[None], (1, 40))
    tpos = torch.arange(40, dtype=torch.int32)[None]
    naive = JLay._sdpa_naive(jq, jk, jv, jpos, jpos, True, None)
    ref_chunked = JLay._sdpa_chunked(jq, jk, jv, jpos, jpos, True, None, 16)
    assert np.abs(np.asarray(ref_chunked - naive)).max() > 0.1
    _close(TLay._sdpa_chunked(tq, tk, tv, tpos, tpos, True, None, 16), naive,
           F32_TOL)
    _close(TLay._sdpa_chunked(tq, tk, tv, tpos, tpos, True, 8, 16),
           JLay._sdpa_naive(jq, jk, jv, jpos, jpos, True, 8), F32_TOL)
    cfg, tcfg = _cfgs("qwen3-4b", "float32", attn_impl="chunked",
                      attn_chunk=8)
    jp, tp = _params("qwen3-4b", "float32")
    toks = _tokens("qwen3-4b", 12)
    want = jax.jit(JS.make_prefill_step(dataclasses.replace(
        cfg, attn_impl="naive")))(jp, {"tokens": jnp.asarray(toks)})
    got = TS.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, F32_TOL)


# --------------------------------------------------------------------------- #
# the committed serve reference (checked on the card by chip_smoke.py)
# --------------------------------------------------------------------------- #

def test_llama3_smoke_serve_reference_file_is_what_jax_computes():
    ref = json.loads(SERVE_REF_PATH.read_text())
    want = llama3_smoke_serve_reference()
    assert ref.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list) and k != "prompt":
            np.testing.assert_allclose(ref[k], v, rtol=1e-6, atol=1e-6)
        else:
            assert ref[k] == v, k


def test_port_matches_the_serve_reference_on_cpu():
    """What chip_smoke.py checks on the card, here on the CPU: pallas
    prefill, and pallas and naive decode from an f32 cache, at 1e-4;
    naive decode from the bf16 cache at 2e-2."""
    ref = json.loads(SERVE_REF_PATH.read_text())
    tcfg = dataclasses.replace(get_config(ref["arch"], smoke=True),
                               dtype="float32", attn_impl="pallas")
    tp = lm_params_from_jax(lm_weights(tcfg, ref["seed"]), tcfg,
                            device="cpu")
    toks = np.asarray(ref["prompt"], np.int32)
    got = TS.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    _close(got, np.reshape(ref["prefill_last_logits"], got.shape), 1e-4)
    shape = (ref["steps"], ref["batch"], tcfg.vocab)
    for impl in ("pallas", "naive"):
        got = _port_decode(dataclasses.replace(tcfg, attn_impl=impl), tp,
                           toks, torch.float32)
        _close(got, np.reshape(ref["decode_logits_f32_cache"], shape), 1e-4)
    got = _port_decode(dataclasses.replace(tcfg, attn_impl="naive"), tp,
                       toks, torch.bfloat16)
    _close(got, np.reshape(ref["decode_logits_bf16_cache"], shape),
           BF16_CACHE_TOL)


# --------------------------------------------------------------------------- #
# entry points, unported kinds, the package boundary
# --------------------------------------------------------------------------- #

def test_serve_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, tcfg = _cfgs("llama3-8b", "float32", attn_impl="pallas")
    _, tp = _params("llama3-8b", "float32")
    toks = torch.from_numpy(_tokens("llama3-8b", 4))
    for call in (lambda: TS.make_prefill_step(tcfg),
                 lambda: TS.make_decode_step(tcfg),
                 lambda: TS.greedy_generate(tp, tcfg, toks, 2, 8),
                 lambda: TL.init_cache(tcfg, 2, 8),
                 lambda: lm_params_from_jax(lm_weights(cfg, 0), tcfg)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # the CPU runs only when asked, and parameters must be on the step's
    # device
    TS.make_prefill_step(tcfg, device="cpu")(tp, {"tokens": toks})
    meta = {"embed": tp["embed"].to("meta")}
    with pytest.raises(ValueError, match="params are on meta"):
        TS.make_prefill_step(tcfg, device="cpu")(meta, {"tokens": toks})


def test_unported_kinds_and_paths_raise_naming_their_roadmap_item():
    gen = torch.Generator().manual_seed(0)
    # every kind of the reference is ported: whisper (encdec) and internvl2
    # (vlm) build and serve on the CPU (tests/test_torch_encdec.py,
    # tests/test_torch_vlm.py); a kind the reference does not know raises
    for arch, extra in (("whisper-small", "frames"),
                        ("internvl2-26b", "vis_embed")):
        cfg = get_config(arch, smoke=True)
        params = TL.init_params(gen, cfg)
        n = cfg.enc_seq if extra == "frames" else cfg.n_vis_tokens
        logits = TS.make_prefill_step(cfg, device="cpu")(params, {
            "tokens": torch.zeros((1, 4), dtype=torch.int32),
            extra: torch.randn((1, n, cfg.d_model), generator=gen)})
        assert logits.shape == (1, cfg.vocab)
        cache = TL.init_cache(cfg, 1, 8, device="cpu")
        logits, _ = TS.make_decode_step(cfg, device="cpu")(
            params, cache, torch.zeros((1, 1), dtype=torch.int32), 0)
        assert bool(torch.isfinite(logits).all())
    odd = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              kind="rnn")
    for call in (lambda: TL.init_params(gen, odd),
                 lambda: TS.make_prefill_step(odd, device="cpu"),
                 lambda: TL.init_cache(odd, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="unknown kind"):
            call()
    # mamba2 and zamba2 (ssm, hybrid), the SSD scan (B6), mixtral and grok
    # (moe) are ported (tests/test_torch_ssm.py, tests/test_torch_ssd.py,
    # tests/test_torch_moe.py)
    for arch in ("mamba2-2.7b", "zamba2-2.7b", "mixtral-8x22b",
                 "grok-1-314b"):
        cfg = get_config(arch, smoke=True)
        TL.init_params(gen, cfg)
        TS.make_prefill_step(cfg, device="cpu")
        TL.init_cache(cfg, 1, 8, device="cpu")
    x = torch.ones((1, 16, 2, 4))
    y = tops.ssd_scan(x, torch.ones((1, 16, 2)), -torch.ones(2),
                      torch.ones((1, 16, 3)), torch.ones((1, 16, 3)), 8)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    # the pallas kernel against a sliding-window ring cache decodes: a ring
    # of 4 slots wrapping twice, as the naive path decodes it
    tcfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                               dtype="float32", attn_impl="pallas", window=4)
    _, tp = _params("llama3-8b", "float32")
    toks = _tokens("llama3-8b", 10)
    got = _port_decode(tcfg, tp, toks, torch.float32)
    assert got.shape == (10, B, tcfg.vocab) and np.isfinite(got).all()
    _close(got, _port_decode(dataclasses.replace(tcfg, attn_impl="naive"),
                             tp, toks, torch.float32), F32_TOL)
    with pytest.raises(ValueError, match="position"):
        TL.decode_step(tp, TL.init_cache(tcfg, B, 8, device="cpu"),
                       torch.zeros((B, 1), dtype=torch.int32), 3,
                       dataclasses.replace(tcfg, window=None))


def test_lm_modules_import_no_jax_and_nothing_of_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for sub in ("models", "configs", "runtime", "kernels"):
        for f in (ROOT / "src" / "repro_torch" / sub).rglob("*.py"):
            assert not pat.search(f.read_text()), f
    code = ("import sys, repro_torch.runtime.serve, repro_torch.configs, "
            "repro_torch.kernels.ops, repro_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"})
    assert repro_torch.resolve_device("cpu").type == "cpu"
