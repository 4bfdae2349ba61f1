"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Skips without a CUDA device (and imports no JAX, so it also runs on the
card's machine): ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  ``chip_smoke.py`` runs the same checks at the
full perm1024 / perm8k shapes and at llama3-8b's, mamba2-2.7b's and
zamba2-2.7b's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core.params import NetworkSpec
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import fabric_kernels as fk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import (flash_attention_ref, ssd_chunked_ref,
                                     ssd_ref)
from repro_torch.runtime.serve import (greedy_generate, make_decode_step,
                                       make_prefill_step)
from repro_torch.models import lm
from repro_torch.sim import fabric as TF
from repro_torch.sim.topology import full_bisection
from repro_torch.sim.workloads import permutation_scenario

from torch_lm_weights import lm_weights
from torch_parity import SERVE_REF_PATH, SSM_SERVE_REF_PATHS

pytestmark = [pytest.mark.torch, pytest.mark.cuda]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [255, 256, 257, 511, 512, 513, 4096, 32768])
def test_ranker_kernel_matches_plain(cuda, m):
    rng = np.random.default_rng(m)
    for span, density in ((97, 0.5), (3, 1.0), (7, 0.0)):
        qid = torch.from_numpy(rng.integers(0, span, m).astype(np.int32))
        flag = torch.from_numpy(rng.random(m) < density)
        qid, flag = qid.to(cuda), flag.to(cuda)
        assert torch.equal(fk.rank_in_queue(qid, flag, 97),
                           fk.rank_in_queue_plain(qid, flag, 97))


def test_fabric_on_the_card_equals_the_cpu(cuda):
    sc = permutation_scenario(full_bisection(8, 16), 64 * 2 ** 10,
                              net=NetworkSpec(link_gbps=400.0), seed=0)
    cfg = TF.FabricConfig(net=sc.net, time_warp=True, trace_every=0)
    fk.reset_launches()
    _, m_gpu = TF.run_fabric_trace(sc.topo, sc.messages, 2000, cfg,
                                   device=cuda)
    assert all(n > 0 for n in fk.launches.values()), fk.launches
    _, m_cpu = TF.run_fabric_trace(sc.topo, sc.messages, 2000, cfg,
                                   device="cpu")
    np.testing.assert_array_equal(m_gpu["done_tick"], m_cpu["done_tick"])
    assert m_gpu["warp_trips"] == m_cpu["warp_trips"]
    assert m_gpu["ecn_marks"] == m_cpu["ecn_marks"]


@pytest.mark.parametrize("B,H,K,Tq,Tk,hd,causal,window,q_offset", [
    (1, 4, 4, 128, 128, 64, True, None, 0),
    (2, 8, 2, 256, 256, 64, True, None, 0),
    (1, 4, 1, 128, 384, 128, True, None, 0),
    (2, 2, 2, 100, 100, 32, True, None, 0),
    (1, 2, 2, 64, 192, 64, False, None, 0),
    (1, 2, 2, 256, 256, 64, True, 96, 0),
    (2, 4, 2, 1, 512, 64, True, None, 300),
    (3, 4, 1, 1, 100, 16, True, None, 99),
    (1, 2, 1, 8, 8, 16, True, None, -4),
])
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16")])
def test_flash_attention_kernel_matches_plain(cuda, B, H, K, Tq, Tk, hd,
                                              causal, window, q_offset,
                                              dtypes):
    """The CUDA kernel against its plain version on the card, on the cases
    of tests/test_torch_flash.py: 2e-5 in f32, 2e-2 in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(Tq * 7 + Tk)
    qdt, kvdt = (getattr(torch, d) for d in dtypes)
    q = torch.randn((B, H, Tq, hd), generator=g, device=cuda).to(qdt)
    k = torch.randn((B, K, Tk, hd), generator=g, device=cuda).to(kvdt)
    v = torch.randn((B, K, Tk, hd), generator=g, device=cuda).to(kvdt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches["flash_attention"] == 1
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == qdt and got.shape == want.shape
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # model layout: strided views, no copy
    got_t = fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v, **kw)
    torch.testing.assert_close(got_t, got, rtol=0, atol=0)


def test_llama3_smoke_serve_on_the_card_matches_the_jax_reference(cuda):
    """The f32 SMOKE model on the card: pallas prefill and pallas decode
    (the kernel, q_offset = pos) from an f32 cache against the JAX-made
    reference, 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = json.loads(SERVE_REF_PATH.read_text())
    cfg = dataclasses.replace(get_config(ref["arch"], smoke=True),
                              dtype="float32", attn_impl="pallas")
    params = lm_params_from_jax(lm_weights(cfg, ref["seed"]), cfg)
    toks = torch.tensor(ref["prompt"], dtype=torch.int32, device=cuda)
    fa.reset_launches()
    got = make_prefill_step(cfg)(params, {"tokens": toks})
    want = torch.tensor(ref["prefill_last_logits"], device=cuda)
    torch.testing.assert_close(got.ravel(), want, rtol=1e-4, atol=1e-4)
    cache = lm.init_cache(cfg, ref["batch"], ref["steps"],
                          dtype=torch.float32)
    step = make_decode_step(cfg)
    out = []
    for t in range(ref["steps"]):
        logits, cache = step(params, cache, toks[:, t:t + 1], t)
        out.append(logits)
    want = torch.tensor(ref["decode_logits_f32_cache"], device=cuda)
    torch.testing.assert_close(torch.stack(out).ravel(), want, rtol=1e-4,
                               atol=1e-4)
    assert fa.launches["flash_attention"] == cfg.n_layers * (1 + ref["steps"])


@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 64, 128), (1, 64, 8, 16, 32, 64),
    (2, 45, 3, 16, 8, 128), (1, 512, 3, 72, 128, 128), (2, 96, 2, 8, 20, 48),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_matches_plain(cuda, B, T, H, P, N, chunk, dtype):
    """The CUDA kernel against its plain version on the card: y and the
    final state, 1e-4 in f32 and 5e-2 in bf16 (the reference's own
    tolerances), on the cases of tests/test_torch_ssd.py and on ragged
    shapes (P = 72: a partial column slice; N = 20; L = 48)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(T * 7 + N)
    dt_ = getattr(torch, dtype)
    x = torch.randn((B, T, H, P), generator=g, device=cuda).to(dt_)
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    Bm = (torch.randn((B, T, N), generator=g, device=cuda) / N ** 0.5).to(dt_)
    Cm = (torch.randn((B, T, N), generator=g, device=cuda) / N ** 0.5).to(dt_)
    ssd.reset_launches()
    y, state = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert ssd.launches["ssd_scan"] == 1
    want_y, want_s = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    assert y.dtype == dt_ and state.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), want_y.to(dt_).float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(state, want_s, rtol=tol, atol=tol)
    if T <= 128:
        seq_y, seq_s = ssd_ref(x, dt, A, Bm, Cm)
        torch.testing.assert_close(y.float(), seq_y, rtol=tol, atol=tol)
        torch.testing.assert_close(state, seq_s, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_smoke_serve_on_the_card_matches_the_jax_reference(cuda, arch):
    """The f32 SMOKE model on the card, SSD through the kernel (and zamba2's
    attention through the flash kernel): prefill and decode from an f32
    cache against the JAX-made reference at 2e-3 (bf16 products, see
    tests/test_torch_ssm.py), greedy tokens exact."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = json.loads(SSM_SERVE_REF_PATHS[arch].read_text())
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              attn_impl="pallas")
    params = lm_params_from_jax(lm_weights(cfg, ref["seed"]), cfg)
    toks = torch.tensor(ref["prompt"], dtype=torch.int32, device=cuda)
    ssd.reset_launches()
    got = make_prefill_step(cfg)(params, {"tokens": toks})
    assert ssd.launches["ssd_scan"] == cfg.n_layers
    want = torch.tensor(ref["prefill_last_logits"], device=cuda)
    torch.testing.assert_close(got.ravel(), want, rtol=2e-3, atol=2e-3)
    cache = lm.init_cache(cfg, ref["batch"], ref["steps"],
                          dtype=torch.float32)
    step = make_decode_step(cfg)
    out = []
    for t in range(ref["steps"]):
        logits, cache = step(params, cache, toks[:, t:t + 1], t)
        out.append(logits)
    want = torch.tensor(ref["decode_logits_f32_cache"], device=cuda)
    torch.testing.assert_close(torch.stack(out).ravel(), want, rtol=2e-3,
                               atol=2e-3)
    gen = greedy_generate(params, cfg, toks, ref["new"],
                          ref["steps"] + ref["new"])
    assert gen.tolist() == ref["greedy_tokens"]
