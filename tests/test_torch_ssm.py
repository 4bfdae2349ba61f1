"""The port's Mamba2 and hybrid serving path against the JAX reference on
the CPU.

SMOKE configs of mamba2-2.7b (``kind="ssm"``: 2 Mamba2 layers) and
zamba2-2.7b (``kind="hybrid"``: 4 Mamba2 layers, the shared attention+MLP
block after every 2), in f32 and bf16, with the same weights in both
packages: ``torch_lm_weights`` draws them from a numpy seed in the
reference's layout (non-trivial conv biases, ``D``, ``dt_bias`` and
``norm_w``; conv_B and conv_C drawn apart), and the port takes them
through ``lm_params_from_jax``.  The Mamba2 block (prefill and the
recurrent decode step, cache included), ``forward_hidden``, prefill
logits, teacher-forced decode logits and greedy tokens are held against
the reference's; zamba2's shared attention runs through the pallas path
(the reference's Pallas kernel in interpret mode), except in decode, where
the reference's pallas path drops the position (ROADMAP C6) and the port
is held against its chunked (at one query, naive) decode.

Tolerances.  The reference runs the block input and the six Mamba2
projections in bf16 whatever ``cfg.dtype`` is, so even the f32 models
have bf16 products: an element that rounds to the other bf16 neighbour in
the two packages (their f32 sums differ in order) moves a block's output
by one bf16 step.  Block outputs: 2e-2 (one or two bf16 roundings;
observed 9.8e-4).  f32 model logits: 2e-3 (observed 1.7e-4 for zamba2,
1.2e-6 for mamba2).  bf16 model logits: 5% of the largest logit, as for
the dense models (observed 1.1%).  The decode cache's f32 state: 1e-3.
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
from repro.models import ssm as JS
from repro.runtime import serve as JSV

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TS
from repro_torch.runtime import serve as TSV

from torch_lm_weights import SSM_SERVE_REF, lm_weights, prompt
from torch_parity import (SSM_SERVE_REF_PATHS, jax_teacher_forced,
                          ssm_smoke_serve_reference)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
DTYPES = ["float32", "bfloat16"]
B, T = 2, 32            # two chunks of the SMOKE configs' 16
BLOCK_TOL = 2e-2
F32_LOGIT_TOL = 2e-3
BF16_LOGIT_SHARE = 0.05
STATE_TOL = 1e-3


def _cfgs(arch, dtype, **over):
    """(reference config, port config): the SMOKE config in ``dtype``,
    attention through the pallas path unless ``over`` says otherwise."""
    over = {"attn_impl": "pallas", **over}
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
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    tol = F32_LOGIT_TOL if dtype == "float32" else \
        BF16_LOGIT_SHARE * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol)


def _rand(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _port_decode(tcfg, params, tokens, cache_dtype=torch.float32):
    cache = TL.init_cache(tcfg, tokens.shape[0], tokens.shape[1],
                          dtype=cache_dtype, device="cpu")
    step = TSV.make_decode_step(tcfg, device="cpu")
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = step(params, cache,
                             torch.from_numpy(tokens[:, t:t + 1]), t)
        out.append(logits.numpy())
    return np.stack(out)


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_types_and_scales(arch):
    """init_params: the reference's tree with layers unstacked; the Mamba2
    projections in bf16, its other leaves and the norms in f32, the
    shared block's matrices in cfg.dtype; the reference's constants."""
    cfg, tcfg = _cfgs(arch, "float32")
    want = jax.eval_shape(lambda k: JL.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    got = TL.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(want)
    assert len(got["layers"]) == cfg.n_layers
    flat = jax.tree_util.tree_flatten_with_path(want["layers"])[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        t = functools.reduce(lambda d, k: d[k], keys, got["layers"][1])
        assert tuple(t.shape) == leaf.shape[1:], keys
        assert t.dtype == (torch.bfloat16 if keys[-1] in TS.PROJECTIONS
                           else torch.float32), keys
    if cfg.kind == "hybrid":
        flat = jax.tree_util.tree_flatten_with_path(want["shared_attn"])[0]
        for path, leaf in flat:
            keys = [p.key for p in path]
            t = functools.reduce(lambda d, k: d[k], keys, got["shared_attn"])
            assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    s = got["layers"][0]["ssm"]
    want0 = JS.init_mamba2(jax.random.PRNGKey(0), cfg)
    for name in ("A_log", "D", "dt_bias", "norm_w", "conv_bx"):
        _close(s[name], want0[name], 1e-6)
    assert abs(float(s["w_x"].float().std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(float(s["conv_x"].std()) / 0.2 - 1) < 0.2
    assert not torch.equal(s["conv_B"], s["conv_C"])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_jax_keeps_the_ssm_leaves_f32(arch):
    """In a bf16 config the Mamba2 projections and the dense matrices are
    bf16; conv kernels and biases, A_log, D, dt_bias, norm_w and the norms
    stay f32 with the reference's values."""
    cfg, tcfg = _cfgs(arch, "bfloat16")
    w = lm_weights(cfg, 0)
    tp = lm_params_from_jax(w, tcfg, device="cpu")
    for i in range(cfg.n_layers):
        s = tp["layers"][i]["ssm"]
        for name, t in s.items():
            assert t.dtype == (torch.bfloat16 if name in TS.PROJECTIONS
                               else torch.float32), name
            want = w["layers"]["ssm"][name][i]
            tol = 4e-3 * np.abs(want).max() if t.dtype == torch.bfloat16 \
                else 0
            _close(t, want, tol)
        assert tp["layers"][i]["ln1"].dtype == torch.float32
    if cfg.kind == "hybrid":
        assert tp["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
        assert tp["shared_attn"]["ln2"].dtype == torch.float32
        _close(tp["shared_attn"]["ln1"], w["shared_attn"]["ln1"], 0)


# --------------------------------------------------------------------------- #
# the Mamba2 block
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_mamba2_prefill_matches_jax(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(arch, dtype)
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["ssm"])
    ju, tu = _rand(1, (B, T, cfg.d_model), dtype)
    want, _ = JS.apply_mamba2(jl, ju, cfg)
    got, cache = TS.apply_mamba2(tp["layers"][1]["ssm"], tu, tcfg)
    assert cache is None and got.dtype == tu.dtype
    _close(got, want, BLOCK_TOL)
    jx, tx = _rand(2, (B, T, 24), "float32")
    _close(TS._causal_conv(tx, tp["layers"][1]["ssm"]["conv_x"][:, :24],
                           tp["layers"][1]["ssm"]["conv_bx"][:24]),
           JS._causal_conv(jx, jl["conv_x"][:, :24], jl["conv_bx"][:24]),
           1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_mamba2_decode_steps_match_jax(arch, dtype):
    """Six recurrent steps from an empty cache: every output, then the
    cache (state, conv windows, pos)."""
    cfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(arch, dtype)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
    jc = JS.init_ssm_cache(cfg, B)
    tc = TS.init_ssm_cache(tcfg, B, device="cpu")
    ju, tu = _rand(3, (B, 6, cfg.d_model), dtype)
    for t in range(6):
        want, jc = JS.apply_mamba2(jl, ju[:, t:t + 1], cfg, cache=jc)
        got, tc = TS.apply_mamba2(tp["layers"][0]["ssm"], tu[:, t:t + 1],
                                  tcfg, cache=tc)
        _close(got, want, BLOCK_TOL)
    assert tc["pos"] == int(jc["pos"]) == 6
    for k in ("state", "conv_x", "conv_B", "conv_C"):
        assert tc[k].dtype == torch.float32
        _close(tc[k], jc[k], STATE_TOL)


# --------------------------------------------------------------------------- #
# the model and the serve steps
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_prefill_logits_match_jax(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(arch, dtype)
    toks = _tokens(arch)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, _ = JL.forward_hidden(jp, JL.embed_tokens(jp, jnp.asarray(toks),
                                                     cfg),
                                jnp.asarray(pos), cfg)
    got, aux = TL.forward_hidden(tp, TL.embed_tokens(
        tp, torch.from_numpy(toks), tcfg), torch.from_numpy(pos.copy()), tcfg)
    assert float(aux) == 0.0 and got.dtype == getattr(torch, dtype)
    _close_logits(got, want, dtype)
    want = jax.jit(JSV.make_prefill_step(cfg))(jp,
                                               {"tokens": jnp.asarray(toks)})
    tssd.reset_launches()
    got = TSV.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
    assert tssd.launches["ssd_scan"] == 0
    _close_logits(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_logits_match_jax(arch, dtype):
    """Decode from an empty cache, one prompt token a step, every step's
    logits, against the reference's chunked decode (ROADMAP C6 for its
    pallas one): the port's pallas (the flash kernel's plain version with
    q_offset) and chunked decodes; the shared KV cache in f32 (f32 model)
    or bf16 (the default)."""
    cfg, tcfg = _cfgs(arch, dtype, attn_impl="chunked")
    jp, tp = _params(arch, dtype)
    toks = _tokens(arch)
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_teacher_forced(cfg, jp, toks, cdt)
    for impl in ("pallas", "chunked"):
        got = _port_decode(dataclasses.replace(tcfg, attn_impl=impl), tp,
                           toks, getattr(torch, str(cdt.dtype)))
        _close_logits(got, want, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_at_the_last_prompt_position_matches_prefill(arch):
    """Inside the port, f32: the recurrent decode's logits at the last
    prompt step equal the chunked prefill's (both through the pallas
    path)."""
    _, tcfg = _cfgs(arch, "float32")
    _, tp = _params(arch, "float32")
    toks = _tokens(arch)
    pre = TSV.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    dec = _port_decode(tcfg, tp, toks)[-1]
    _close(pre, dec, F32_LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_match_jax(arch):
    """f32: the port's greedy tokens through the pallas path (and the
    chunked one) equal the reference's through its chunked attention."""
    cfg, tcfg = _cfgs(arch, "float32", attn_impl="chunked")
    jp, tp = _params(arch, "float32")
    toks = _tokens(arch, 8)
    want = np.asarray(JSV.greedy_generate(jp, cfg, jnp.asarray(toks), 8, 16))
    for impl in ("pallas", "chunked"):
        got = TSV.greedy_generate(tp, dataclasses.replace(tcfg,
                                                          attn_impl=impl),
                                  torch.from_numpy(toks), 8, 16, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_zamba2_reference_pallas_decode_is_c6_and_the_port_is_not():
    """ROADMAP C6 in the hybrid: the reference's pallas decode of zamba2
    (its shared block's attention puts the query at position 0) differs
    from its chunked decode by O(1) logits; the port's pallas decode
    matches the chunked one."""
    cfg, tcfg = _cfgs("zamba2-2.7b", "float32")
    jp, tp = _params("zamba2-2.7b", "float32")
    toks = _tokens("zamba2-2.7b", 12)
    chunked = jax_teacher_forced(dataclasses.replace(cfg, attn_impl="chunked"),
                                 jp, toks, jnp.float32)
    ref_pallas = jax_teacher_forced(cfg, jp, toks, jnp.float32)
    assert np.abs(ref_pallas - chunked).max() > 0.1
    _close(_port_decode(tcfg, tp, toks), chunked, F32_LOGIT_TOL)


# --------------------------------------------------------------------------- #
# the committed serve references (checked on the card by chip_smoke.py)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_smoke_serve_reference_file_is_what_jax_computes(arch):
    ref = json.loads(SSM_SERVE_REF_PATHS[arch].read_text())
    want = ssm_smoke_serve_reference(arch)
    assert ref.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list) and k not in ("prompt", "greedy_tokens"):
            np.testing.assert_allclose(ref[k], v, rtol=1e-6, atol=1e-6)
        else:
            assert ref[k] == v, k


@pytest.mark.parametrize("arch", ARCHS)
def test_port_matches_the_ssm_serve_reference_on_cpu(arch):
    """What chip_smoke.py checks on the card, here on the CPU: pallas
    prefill, pallas decode from an f32 cache (F32_LOGIT_TOL) and greedy
    tokens (exact)."""
    ref = json.loads(SSM_SERVE_REF_PATHS[arch].read_text())
    assert {k: ref[k] for k in SSM_SERVE_REF[arch]} == SSM_SERVE_REF[arch]
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                               attn_impl="pallas")
    tp = lm_params_from_jax(lm_weights(tcfg, ref["seed"]), tcfg,
                            device="cpu")
    toks = np.asarray(ref["prompt"], np.int32)
    got = TSV.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    _close(got, np.reshape(ref["prefill_last_logits"], got.shape),
           F32_LOGIT_TOL)
    got = _port_decode(tcfg, tp, toks)
    _close(got, np.reshape(ref["decode_logits_f32_cache"], got.shape),
           F32_LOGIT_TOL)
    gen = TSV.greedy_generate(tp, tcfg, torch.from_numpy(toks), ref["new"],
                              ref["steps"] + ref["new"], device="cpu")
    np.testing.assert_array_equal(gen.numpy(), ref["greedy_tokens"])


# --------------------------------------------------------------------------- #
# entry points and caches
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_points_default_to_cuda_and_never_fall_back(arch,
                                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, tcfg = _cfgs(arch, "float32")
    _, tp = _params(arch, "float32")
    toks = torch.from_numpy(_tokens(arch, 4))
    for call in (lambda: TSV.make_prefill_step(tcfg),
                 lambda: TSV.make_decode_step(tcfg),
                 lambda: TSV.greedy_generate(tp, tcfg, toks, 2, 8),
                 lambda: TL.init_cache(tcfg, 2, 8),
                 lambda: TS.init_ssm_cache(tcfg, 2),
                 lambda: lm_params_from_jax(lm_weights(cfg, 0), tcfg)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    TSV.make_prefill_step(tcfg, device="cpu")(tp, {"tokens": toks})


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout_and_position_check(arch):
    """One f32 Mamba2 cache per layer; the hybrid's one KV cache per
    application of the shared block (zamba2: 54 / 6 = 9); every cache's
    pos must be the step's position."""
    full = get_config(arch)
    _, tcfg = _cfgs(arch, "float32")
    _, tp = _params(arch, "float32")
    cache = TL.init_cache(tcfg, B, 8, device="cpu")
    assert len(cache["layers"]) == tcfg.n_layers
    lc = cache["layers"][0]
    assert lc["state"].shape == (B, tcfg.ssm_heads, tcfg.ssm_state,
                                 tcfg.ssm_head_dim)
    assert lc["conv_x"].shape == (B, tcfg.ssm_conv - 1,
                                  tcfg.ssm_expand * tcfg.d_model)
    assert all(c["state"].dtype == torch.float32 for c in cache["layers"])
    if tcfg.kind == "hybrid":
        assert full.n_layers // full.hybrid_attn_every == 9
        assert len(cache["shared"]) == tcfg.n_layers // tcfg.hybrid_attn_every
        assert cache["shared"][0]["k"].dtype == torch.bfloat16
    else:
        assert "shared" not in cache
    tok = torch.zeros((B, 1), dtype=torch.int32)
    TL.decode_step(tp, cache, tok, 0, tcfg)
    assert all(c["pos"] == 1 for c in cache["layers"]
               + cache.get("shared", []))
    with pytest.raises(ValueError, match="position"):
        TL.decode_step(tp, cache, tok, 0, tcfg)
