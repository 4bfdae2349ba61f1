"""The port's MoE serving path against the JAX reference on the CPU.

SMOKE configs of mixtral-8x22b (4 experts, top-2, sliding window 32) and
grok-1-314b (the same without a window), in f32 and bf16, with the same
weights in both packages: ``torch_lm_weights`` draws them from a numpy
seed in the reference's layout and the port takes them through
``lm_params_from_jax``.  ``apply_moe`` (its routing decisions too) and
``apply_moe_dense``, ``forward_hidden``, prefill logits for each attention
implementation (pallas against the reference's Pallas kernel in interpret
mode), decode inside and across mixtral's ring, greedy tokens and the
committed serve references are held against the reference's.

The reference's ring decode attends slots never written (ROADMAP C18), so
a windowed decode is held against what the reference computes correctly:
its decode without a window while the window does not bite, and its
prefill of each prefix at ``capacity_factor`` E / k = 2 or more, where no
token is dropped (the capacity-free function a decode computes).

Tolerances.  f32: 1e-5 (summation order and libm ulps).  bf16 layers:
2e-2, one or two bf16 roundings apart.  bf16 logits: 5% of the largest
logit, as for the dense models (tests/test_torch_lm.py).
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
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.ref import flash_attention_ref, ring_positions
from repro_torch.models import layers as TLay
from repro_torch.models import lm as TL
from repro_torch.runtime import serve as TS

from torch_lm_weights import MOE_SERVE_REF, lm_weights, prompt
from torch_parity import (MOE_SERVE_REF_PATHS, jax_position_logits,
                          jax_teacher_forced, moe_smoke_serve_reference)

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

ARCHS = ["mixtral-8x22b", "grok-1-314b"]
DTYPES = ["float32", "bfloat16"]
B, T = 2, 40            # past mixtral SMOKE's window of 32
F32_TOL = 1e-5
BF16_LAYER_TOL = 2e-2
BF16_LOGIT_SHARE = 0.05
#: E / k at SMOKE is 2: at twice that no group can overflow an expert.
DROP_FREE = 4.0


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


def _moe0(arch, dtype):
    jp, tp = _params(arch, dtype)
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            tp["layers"][0]["moe"])


def _tokens(arch, n=T):
    return prompt(j_get_config(arch, smoke=True), 0, B, n)


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


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


def _jax_routing(p, x, cfg, group):
    """The reference's routing decisions (``layers.py:305-319``), which
    ``apply_moe`` keeps to itself: top-k experts and the kept mask."""
    B_, T_, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    g = min(group, T_)
    xg = x.reshape(B_ * (T_ // g), g, d).astype(JLay.dtype_of(cfg))
    S = xg.shape[0]
    logits = (xg @ p["router"].astype(xg.dtype)).astype(jnp.float32)
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    C = max(1, int(cfg.capacity_factor * g * k / E))
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(S, g * k, E), axis=1).reshape(
        S, g, k, E) * onehot - 1.0
    return np.asarray(topi), np.asarray((pos < C) & (onehot > 0))


def _port_decode(tcfg, params, tokens, cache_len, cache_dtype, new=0):
    """Teacher-forced decode logits (T, B, vocab) from an empty cache; with
    ``new``, instead the (B, new) greedy tokens after ``tokens``
    (``greedy_generate`` with a cache of ``cache_dtype``)."""
    cache = TL.init_cache(tcfg, tokens.shape[0], cache_len,
                          dtype=cache_dtype, device="cpu")
    step = TS.make_decode_step(tcfg, device="cpu")
    T_ = tokens.shape[1]
    out, tok = [], torch.from_numpy(tokens[:, :1])
    for t in range(T_ + max(new - 1, 0)):
        logits, cache = step(params, cache, tok, t)
        if t + 1 < T_:
            tok = torch.from_numpy(tokens[:, t + 1:t + 2])
        else:
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok.numpy()[:, 0] if new else logits.numpy())
    return np.stack(out[T_ - 1:], axis=1) if new else np.stack(out)


# --------------------------------------------------------------------------- #
# init and the MoE layers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_types_and_scales(arch):
    cfg, tcfg = _cfgs(arch, "bfloat16")
    want = jax.eval_shape(lambda k: JL.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    got = TL.init_params(torch.Generator().manual_seed(0), tcfg)
    assert sorted(got) == sorted(want) and len(got["layers"]) == cfg.n_layers
    flat = jax.tree_util.tree_flatten_with_path(want["layers"])[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        t = functools.reduce(lambda d, k: d[k], keys, got["layers"][1])
        assert tuple(t.shape) == leaf.shape[1:], keys
        norm = keys[-1] in ("ln1", "ln2")
        assert t.dtype == (torch.float32 if norm else torch.bfloat16), keys
    moe = got["layers"][0]["moe"]
    assert sorted(moe) == ["router", "wd", "wg", "wu"]
    for name, d_in in (("router", cfg.d_model), ("wg", cfg.d_model),
                       ("wd", cfg.d_ff)):
        assert abs(float(moe[name].float().std()) * d_in ** 0.5 - 1) < 0.15


@pytest.mark.parametrize("group", [None, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_moe_and_its_routing_match_jax(dtype, group):
    """T = 32 in one group of 32, or in four groups of 8 (capacity 5 of 16
    assignments over 4 experts), where tokens are dropped."""
    cfg, tcfg = _cfgs("mixtral-8x22b", dtype)
    jp, tp = _moe0("mixtral-8x22b", dtype)
    jx, tx = _x(1, (B, 32, cfg.d_model), dtype)
    want, jaux = JLay.apply_moe(jp, jx, cfg, group=group)
    got, aux = TLay.apply_moe(tp, tx, tcfg, group=group)
    assert got.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_LAYER_TOL
    _close(got, want, tol)
    _close(aux, jaux, tol)
    r = TLay.moe_routing(tp, tx, tcfg, group)
    assert r["C"] == (5 if group == 8 else 20)
    dropped = int(TLay.moe_dropped(tp, tx, tcfg, group))
    assert dropped == int((r["onehot"] > 0).sum() - r["keep"].sum())
    if group == 8:
        assert dropped > 0      # not vacuous: the capacity bites
    if dtype == "float32":
        topi, keep = _jax_routing(jp, jx, cfg, group or cfg.moe_group)
        np.testing.assert_array_equal(r["topi"].numpy(), topi)
        np.testing.assert_array_equal(r["keep"].numpy(), keep)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_moe_dense_matches_jax(dtype):
    cfg, tcfg = _cfgs("grok-1-314b", dtype)
    jp, tp = _moe0("grok-1-314b", dtype)
    jx, tx = _x(2, (B, 3, cfg.d_model), dtype)
    want, _ = JLay.apply_moe_dense(jp, jx, cfg)
    got, aux = TLay.apply_moe_dense(tp, tx, tcfg)
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(got, want, F32_TOL if dtype == "float32" else BF16_LAYER_TOL)


def test_gate_ties_go_to_the_lower_expert_index():
    """Router columns 1 and 3 equal, so every token's gates for experts 1
    and 3 tie exactly: lax.top_k takes 1 first; so does the port (a stable
    sort), in both MoE layers."""
    cfg, tcfg = _cfgs("mixtral-8x22b", "float32")
    jp, tp = _moe0("mixtral-8x22b", "float32")
    router = np.array(jp["router"])
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    jx, tx = _x(3, (B, 32, cfg.d_model), "float32")
    r = TLay.moe_routing(tp, tx, tcfg)
    topi, keep = _jax_routing(jp, jx, cfg, cfg.moe_group)
    tied = (r["gates"][..., 1] == r["gates"][..., 3]).numpy()
    first = np.argmax((topi == 1) | (topi == 3), axis=-1)  # the one ranked
    picked = ((topi == 1) | (topi == 3)).any(-1)          # higher of the two
    assert tied.all() and ((topi == 1) & (topi[..., :1] != 3)).any() \
        and (topi[..., -1:] == 3).any()
    assert (np.take_along_axis(topi, first[..., None], -1)[..., 0][picked]
            == 1).all()
    np.testing.assert_array_equal(r["topi"].numpy(), topi)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    _close(TLay.apply_moe(tp, tx, tcfg)[0], JLay.apply_moe(jp, jx, cfg)[0],
           F32_TOL)
    _close(TLay.apply_moe_dense(tp, tx[:, :2], tcfg)[0],
           JLay.apply_moe_dense(jp, jx[:, :2], cfg)[0], F32_TOL)
    vals = torch.tensor([[0.5, 0.2, 0.5, 0.2, 0.5]])
    want_v, want_i = jax.lax.top_k(jnp.asarray(vals.numpy()), 4)
    got_v, got_i = TLay.top_k(vals, 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# --------------------------------------------------------------------------- #
# the model and the serve steps
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype, impl", [
    ("float32", "naive"), ("float32", "chunked"), ("float32", "pallas"),
    ("bfloat16", "naive")])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_prefill_logits_match_jax(arch, dtype, impl):
    """40 tokens (mixtral's window of 32 bites), chunked in 8-key chunks;
    the routing loss summed over the layers too.  In bf16 only the naive
    path, whose attention rounds as the reference's does: the router's
    logits are bf16, so gates tie or nearly tie (gaps of 0 to 2e-3 at
    SMOKE), and where the chunked or pallas attention rounds differently
    from the reference's a tied token picks another expert, which moves its
    own and, through attention, later positions by O(1) (mixtral, pallas:
    18 of 80 positions past 5% of the largest value).  The bf16 layers are
    held without that in test_apply_moe_* and tests/test_torch_flash.py."""
    cfg, tcfg = _cfgs(arch, dtype, attn_impl=impl, attn_chunk=8)
    jp, tp = _params(arch, dtype)
    toks = _tokens(arch)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, jaux = JL.forward_hidden(
        jp, JL.embed_tokens(jp, jnp.asarray(toks), cfg), jnp.asarray(pos),
        cfg)
    got, aux = TL.forward_hidden(tp, TL.embed_tokens(
        tp, torch.from_numpy(toks), tcfg), torch.from_numpy(pos.copy()), tcfg)
    assert got.dtype == getattr(torch, dtype)
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_SHARE * scale
    _close(got, want, tol)
    _close(aux, jaux, F32_TOL if dtype == "float32" else BF16_LAYER_TOL)
    want = jax.jit(JS.make_prefill_step(cfg))(jp,
                                              {"tokens": jnp.asarray(toks)})
    got = TS.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab)
    _close_logits(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_inside_the_window_matches_jax_without_one(arch, dtype):
    """16 tokens, a ring of 16 slots that never wraps, inside mixtral's
    window of 32: the same function as the reference's decode without a
    window (whose cache is no ring: C18 does not arise).  Each port
    implementation against it, the dense MoE in every step."""
    cfg, tcfg = _cfgs(arch, dtype, attn_impl="naive")
    jp, tp = _params(arch, dtype)
    toks = _tokens(arch, 16)
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_teacher_forced(dataclasses.replace(cfg, window=None), jp, toks,
                              cdt)
    for impl in ("naive", "pallas"):
        got = _port_decode(dataclasses.replace(tcfg, attn_impl=impl), tp,
                           toks, 16, getattr(torch, dtype))
        _close_logits(got, want, dtype)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_decode_across_the_ring_wrap_matches_jax_prefills(impl):
    """mixtral SMOKE, f32: 40 tokens through a ring of 32 slots (the window),
    which wraps at position 32, against the reference's prefill of each
    prefix at a drop-free capacity factor: the positions' logits of one
    forward pass, and literal prefills of 32, 33 and 40 tokens."""
    cfg, tcfg = _cfgs("mixtral-8x22b", "float32", attn_impl="naive",
                      capacity_factor=DROP_FREE)
    jp, tp = _params("mixtral-8x22b", "float32")
    toks = _tokens("mixtral-8x22b")
    got = _port_decode(dataclasses.replace(tcfg, attn_impl=impl), tp, toks,
                       T, torch.float32)
    _close(got, jax_position_logits(cfg, jp, toks), F32_TOL)
    prefill = JS.make_prefill_step(cfg)
    for n in (32, 33, 40):
        want = prefill(jp, {"tokens": jnp.asarray(toks[:, :n])})
        _close(got[n - 1], want, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    """f32: greedy tokens through the decode ring (pallas and naive) from an
    f32 cache equal the reference's argmax of a drop-free prefill of
    everything so far; ``greedy_generate`` (a bf16 cache, as in the
    reference) gives the same tokens as that loop from a bf16 cache and,
    for grok (no ring: C18 does not arise), as the reference's own
    ``greedy_generate``."""
    cfg, tcfg = _cfgs(arch, "float32", attn_impl="naive")
    ref = json.loads(MOE_SERVE_REF_PATHS[arch].read_text())
    _, tp = _params(arch, "float32")
    toks, new = np.asarray(ref["prompt"], np.int32), ref["new"]
    for impl in ("pallas", "naive"):
        c = dataclasses.replace(tcfg, attn_impl=impl)
        got = _port_decode(c, tp, toks, T + new, torch.float32, new)
        np.testing.assert_array_equal(got, ref["greedy_tokens"])
        gen = TS.greedy_generate(tp, c, torch.from_numpy(toks), new, T + new,
                                 device="cpu")
        assert gen.dtype == torch.int32
        np.testing.assert_array_equal(
            gen.numpy(), _port_decode(c, tp, toks, T + new, torch.bfloat16,
                                      new))
        if cfg.window is None:
            jp, _ = _params(arch, "float32")
            want = JS.greedy_generate(jp, cfg, jnp.asarray(toks), new,
                                      T + new)
            np.testing.assert_array_equal(gen.numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# ROADMAP C18: the reference's ring decode attends slots never written
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch, over", [
    ("mixtral-8x22b", dict(capacity_factor=DROP_FREE)),
    ("llama3-8b", dict(window=32)),
    ("llama3-8b", dict(window=8))])
def test_c18_reference_ring_decode_attends_unwritten_slots(arch, over):
    """12 tokens through a ring of min(12, window) slots.  Until the ring
    fills, the reference's slots past the position hold negative positions
    that pass its causal and window masks, so its decode attends zero keys
    and values: O(1) off its own prefill from step 0 (the first step with
    an unwritten slot) to the last.  The port's decode (naive and pallas)
    equals that prefill at f32 tolerance.  Documents the reference fault;
    does not fix it."""
    cfg, _ = _cfgs(arch, "float32", attn_impl="naive", **over)
    jp = jax.tree.map(jnp.asarray, lm_weights(cfg, 0))
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                               **over)
    tp = lm_params_from_jax(lm_weights(cfg, 0), tcfg, device="cpu")
    toks = _tokens(arch, 12)
    ref_dec = jax_teacher_forced(cfg, jp, toks, jnp.float32)
    prefill = jax_position_logits(cfg, jp, toks)
    assert np.abs(ref_dec[0] - prefill[0]).max() > 1.0
    assert np.abs(ref_dec[-1] - prefill[-1]).max() > 0.1
    want = jax.jit(JS.make_prefill_step(cfg))(jp,
                                              {"tokens": jnp.asarray(toks)})
    _close(prefill[-1], want, F32_TOL)
    for impl in ("naive", "pallas"):
        got = _port_decode(dataclasses.replace(tcfg, attn_impl=impl), tp,
                           toks, 12, torch.float32)
        _close(got, prefill, F32_TOL)


# --------------------------------------------------------------------------- #
# the ring through the flash-attention wrapper and the decode kernel's walk
# --------------------------------------------------------------------------- #

def _ring_walk(S, q_offset, Tq, window):
    """The slots the decode kernel reads for a ring (``dec_kernel`` in
    csrc/flash_attention.cu): positions [k_lo, k_hi) in order, each at
    slot p - base, or p - base + S below base."""
    P = q_offset + Tq - 1
    k_hi, k_lo = P + 1, max(0, P + 1 - S)
    base = P - P % S if P >= 0 else 0
    if window:
        k_lo = max(k_lo, q_offset - window + 1)
    return [(p, p - base if p >= base else p - base + S)
            for p in range(k_lo, k_hi)]


@pytest.mark.parametrize("S", [1, 8, 32, 33])
def test_the_kernels_ring_walk_reads_each_live_slot_once(S):
    """The walk, mirrored, against ``ring_positions``: the slots it reads
    are exactly those holding a position some row may attend, each once,
    with the position the plain version gives the slot; at most two runs
    of consecutive slots."""
    for q_offset in range(-3, 3 * S + 5):
        for Tq in (1, 2, 4):
            for window in (None, 1, 5, S):
                walk = _ring_walk(S, q_offset, Tq, window)
                P = q_offset + Tq - 1
                held = ring_positions(S, P).tolist() if P >= 0 else [-1] * S
                lo = q_offset - window + 1 if window else 0
                live = {j for j, p in enumerate(held) if p >= max(0, lo)}
                slots = [j for _, j in walk]
                assert sorted(slots) == sorted(live), (S, q_offset, Tq)
                assert all(held[j] == p for p, j in walk)
                runs = 1 + sum(b != a + 1 for a, b in zip(slots, slots[1:]))
                assert not slots or runs <= 2


@pytest.mark.parametrize("S, q_offset, Tq, window", [
    (8, 0, 1, None), (8, 5, 1, 8), (8, 7, 1, 8), (8, 8, 1, 8),
    (8, 13, 1, 8), (8, 13, 1, 3), (8, 21, 3, 8), (32, 70, 4, 32),
    (32, 70, 2, 5)])
def test_ring_cache_equals_attention_over_the_positions_it_holds(
        S, q_offset, Tq, window):
    """The plain version's ring, against a linear cache of every position
    0 .. P written in order: the ring holds the last S of them."""
    g = torch.Generator().manual_seed(S + q_offset)
    P = q_offset + Tq - 1
    q = torch.randn((2, 4, Tq, 16), generator=g)
    k_all = torch.randn((2, 2, P + 1, 16), generator=g)
    v_all = torch.randn((2, 2, P + 1, 16), generator=g)
    k = torch.zeros((2, 2, S, 16))
    v = torch.zeros((2, 2, S, 16))
    for p in range(P + 1):
        k[:, :, p % S], v[:, :, p % S] = k_all[:, :, p], v_all[:, :, p]
    lo = max(0, P + 1 - S)
    want = flash_attention_ref(q, k_all[:, :, lo:], v_all[:, :, lo:],
                               window=window, q_offset=q_offset - lo)
    got = tfa.flash_attention(q, k, v, window=window, q_offset=q_offset,
                              ring=True)
    _close(got, want, F32_TOL)


def test_a_ring_reaches_only_the_decode_route():
    bf16 = torch.bfloat16
    assert tfa._route(4, 128, bf16, bf16, 48, 8, ring=True) == "decode"
    for qdt in (bf16, torch.float32):
        with pytest.raises(ValueError, match="ring cache reaches only"):
            tfa._route(5, 128, qdt, bf16, 48, 8, ring=True)
    assert tfa._route(5, 128, bf16, bf16, 48, 8) == "tc"


# --------------------------------------------------------------------------- #
# the committed serve references (checked on the card by chip_smoke.py)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_smoke_serve_reference_file_is_what_jax_computes(arch):
    ref = json.loads(MOE_SERVE_REF_PATHS[arch].read_text())
    assert {k: ref[k] for k in MOE_SERVE_REF[arch]} == MOE_SERVE_REF[arch]
    want = moe_smoke_serve_reference(arch)
    assert ref.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list) and k not in ("prompt", "greedy_tokens"):
            np.testing.assert_allclose(ref[k], v, rtol=1e-6, atol=1e-6)
        else:
            assert ref[k] == v, k


@pytest.mark.parametrize("arch", ARCHS)
def test_port_matches_the_moe_serve_reference_on_cpu(arch):
    """What chip_smoke.py checks on the card, here on the CPU: the pallas
    prefill at the config's capacity factor, the pallas decode of every
    prompt position (through mixtral's ring wrap) at 1e-4, and the greedy
    tokens, all from an f32 cache."""
    ref = json.loads(MOE_SERVE_REF_PATHS[arch].read_text())
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", attn_impl="pallas")
    tp = lm_params_from_jax(lm_weights(tcfg, ref["seed"]), tcfg,
                            device="cpu")
    toks = np.asarray(ref["prompt"], np.int32)
    got = TS.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    _close(got, np.reshape(ref["prefill_last_logits"], got.shape), 1e-4)
    got = _port_decode(tcfg, tp, toks, ref["steps"], torch.float32)
    _close(got, np.reshape(ref["position_logits"], got.shape), 1e-4)
    gen = _port_decode(tcfg, tp, toks, ref["steps"] + ref["new"],
                       torch.float32, ref["new"])
    assert gen.tolist() == ref["greedy_tokens"]
