"""How the port's flash attention picks its CUDA kernel, and what the
tensor-core route's arithmetic does to the result.

``repro_torch.kernels.flash_attention._route`` is a pure function of the
shapes, types, strides and addresses, so the CPU reaches it: bf16 prefill
goes to ``tc`` (wgmma), up to ``DECODE_MAX_TQ`` query rows to ``decode``
(any types), f32 or mixed prefill to ``fma``; what TMA or 16-byte loads
cannot read raises.  The ``tc`` route rounds p to bf16 before ``p @ v``
(the plain version keeps it in f32); :func:`_tc_model` does the same
arithmetic in PyTorch, tile by tile, and is held against the plain
version at llama3-8b-like rows within the bf16 tolerance the card holds
the kernel to (``FA_TOL["bfloat16"]``, ``chip_smoke.py``).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

F32, BF16 = torch.float32, torch.bfloat16

#: The kernel against its plain version in bf16 (chip_smoke.py FA_TOL,
#: tests/test_torch_cuda.py): one bf16 rounding of the output.
BF16_TOL = 2e-2


def _contig(B, H, T, hd):
    """Element strides of a contiguous (B, H, T, hd) tensor."""
    return (H * T * hd, T * hd, hd, 1)


def _model(B, H, T, hd):
    """Element strides of a model-layout (B, T, H, hd) tensor viewed as
    (B, H, T, hd)."""
    return (T * H * hd, hd, H * hd, 1)


@pytest.mark.parametrize("what,Tq,hd,qdt,kvdt,H,K,want", [
    ("llama3 prefill-1000", 1000, 128, BF16, BF16, 32, 8, "tc"),
    ("llama3 prefill-4096", 4096, 128, BF16, BF16, 32, 8, "tc"),
    ("zamba2 prefill-1024", 1024, 80, BF16, BF16, 32, 32, "tc"),
    ("bf16 ragged 100 MQA", 100, 64, BF16, BF16, 32, 1, "tc"),
    ("bf16 Tq 5", 5, 16, BF16, BF16, 4, 2, "tc"),
    ("llama3 decode", 1, 128, BF16, BF16, 32, 8, "decode"),
    ("zamba2 decode", 1, 80, BF16, BF16, 32, 32, "decode"),
    ("chunked decode Tq 4", 4, 128, BF16, BF16, 32, 8, "decode"),
    ("f32 decode", 1, 16, F32, F32, 4, 1, "decode"),
    ("f32 q bf16 cache decode", 2, 64, F32, BF16, 8, 2, "decode"),
    ("bf16 q f32 cache decode", 3, 64, BF16, F32, 8, 2, "decode"),
    ("f32 prefill (SMOKE)", 8, 16, F32, F32, 4, 1, "fma"),
    ("f32 prefill", 100, 128, F32, F32, 32, 8, "fma"),
    ("f32 q bf16 k/v prefill", 100, 128, F32, BF16, 32, 8, "fma"),
    ("bf16 q f32 k/v prefill", 100, 128, BF16, F32, 32, 8, "fma"),
    ("fma takes any hd", 100, 20, F32, F32, 4, 2, "fma"),
])
def test_route_table(what, Tq, hd, qdt, kvdt, H, K, want):
    Tk = max(Tq, 64)
    strides = (_model(2, H, Tq, hd), _contig(2, K, Tk, hd),
               _contig(2, K, Tk, hd))
    assert fa._route(Tq, hd, qdt, kvdt, H, K) == want, what
    assert fa._route(Tq, hd, qdt, kvdt, H, K, strides=strides,
                     addrs=(0, 1 << 20, 2 << 20)) == want, what


@pytest.mark.parametrize("what,args,kw,match", [
    ("hd 256", (1000, 256, BF16, BF16, 32, 8), {}, "hd 256"),
    ("hd 0", (1, 0, F32, F32, 4, 4), {}, "hd 0"),
    ("H % K", (1000, 128, BF16, BF16, 32, 6), {}, "q heads"),
    ("tc hd 20", (1000, 20, BF16, BF16, 4, 2), {}, "multiple of 8"),
    ("decode hd 20", (1, 20, F32, F32, 4, 2), {}, "multiple of 8"),
    ("tc q row stride", (100, 64, BF16, BF16, 4, 2),
     dict(strides=((4 * 100 * 68, 100 * 68, 68, 1), _contig(1, 2, 100, 64),
                   _contig(1, 2, 100, 64))), "q's strides"),
    ("tc v last dim", (100, 64, BF16, BF16, 4, 2),
     dict(strides=(_contig(1, 4, 100, 64), _contig(1, 2, 100, 64),
                   (2 * 100 * 64, 100 * 64, 1, 100))), "v's strides"),
    ("decode k row stride", (1, 64, F32, BF16, 4, 2),
     dict(strides=((256, 64, 64, 1), (2 * 100 * 68, 100 * 68, 68, 1),
                   _contig(1, 2, 100, 64))), "k's strides"),
    ("tc k address", (100, 64, BF16, BF16, 4, 2),
     dict(addrs=(0, 8, 0)), "k is not 16-byte aligned"),
    ("decode v address", (1, 64, BF16, BF16, 4, 2),
     dict(addrs=(0, 0, 1032)), "v is not 16-byte aligned"),
])
def test_route_refuses(what, args, kw, match):
    with pytest.raises(ValueError, match=match):
        fa._route(*args, **kw)


def test_route_holds_only_what_the_route_reads():
    """fma reads through any strides; decode reads q with scalar loads, so
    an odd q stride passes there and fails on tc."""
    odd = ((4 * 100 * 68, 100 * 68, 68, 1), _contig(1, 2, 100, 64),
           _contig(1, 2, 100, 64))
    assert fa._route(100, 64, F32, F32, 4, 2, strides=odd,
                     addrs=(2, 6, 10)) == "fma"
    assert fa._route(1, 64, BF16, BF16, 4, 2, strides=odd,
                     addrs=(2, 0, 0)) == "decode"
    with pytest.raises(ValueError):
        fa._route(100, 64, BF16, BF16, 4, 2, strides=odd)


@pytest.mark.parametrize("B,H,K,Tq,Tk,n_sm,want", [
    (4, 32, 8, 1, 544, 132, (4, 32, 3)),     # llama3 decode: 96 blocks
    (4, 32, 8, 1, 64, 132, (4, 32, 1)),      # short cache: one chunk a warp
    (4, 32, 32, 1, 80, 132, (1, 128, 1)),    # zamba2 decode: 128 groups
    (1, 32, 8, 4, 4096, 132, (8, 16, 8)),    # chunked decode, long cache
    (2, 32, 1, 1, 200, 132, (8, 8, 1)),      # MQA: 32 rows in 4 blocks
    (1, 4, 1, 1, 100, 132, (4, 1, 1)),
])
def test_decode_grid(B, H, K, Tq, Tk, n_sm, want):
    rows, groups, splits = fa._decode_grid(B, H, K, Tq, Tk, n_sm)
    assert (rows, groups, splits) == want
    assert groups * splits <= max(n_sm, groups)


def _tc_model(q, k, v, *, causal=True, q_offset=0, block_k=128,
              p_dtype=torch.bfloat16):
    """The tc route's arithmetic in PyTorch: q . k in f32 from bf16
    values, an online softmax over kv tiles of ``block_k`` in the log2
    domain (m from -1e30), p rounded to ``p_dtype`` before p @ v with an
    f32 accumulator, l summed from the unrounded p, out = acc / max(l,
    1e-20) in q's type."""
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    c = (1.0 / math.sqrt(hd)) * 1.4426950408889634
    qf = q.float().reshape(B, K, H // K, Tq, hd)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(Tq)[:, None] + q_offset
    m = torch.full((B, K, H // K, Tq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, H // K, Tq, hd))
    for k0 in range(0, Tk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kt)
        k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        live = k_pos <= q_pos if causal else torch.ones_like(k_pos <= q_pos)
        s = s.masked_fill(~live, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bksd->bkgqd", p.to(p_dtype).float(), vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(B, H, Tq, hd).to(q.dtype)


@pytest.mark.parametrize("Tk,q_scale,seed", [
    (1000, 1.0, 0),     # prefill-1000's last rows
    (4096, 1.0, 1),     # prefill-4096's last rows: the longest softmax
    (4096, 4.0, 2),     # peaked scores: p near 1 beside many near 0
])
def test_bf16_p_stays_inside_the_bf16_tolerance(Tk, q_scale, seed):
    """llama3-8b-like rows (hd 128, GQA 4:1, causal): the last 128 query
    rows of a Tk-token prefill (q_offset = Tk - 128), bf16 q/k/v from a
    numpy seed.  The tc route's rounding of p to bf16 keeps the output
    within FA_TOL["bfloat16"] of the plain version (which keeps p in f32),
    and the tolerance is not vacuous: the two outputs differ."""
    rng = np.random.default_rng(seed)
    B, H, K, Tq, hd = 1, 8, 2, 128, 128
    q = torch.from_numpy(rng.standard_normal((B, H, Tq, hd),
                                             dtype=np.float32) * q_scale)
    k = torch.from_numpy(rng.standard_normal((B, K, Tk, hd),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, K, Tk, hd),
                                             dtype=np.float32))
    q, k, v = q.to(BF16), k.to(BF16), v.to(BF16)
    got = _tc_model(q, k, v, q_offset=Tk - Tq).float()
    want = flash_attention_ref(q, k, v, q_offset=Tk - Tq).float()
    assert bool((got != want).any())
    d = (got - want).abs()
    assert not bool((d > BF16_TOL + BF16_TOL * want.abs()).any()), \
        float(d.max())


def test_tc_model_equals_the_plain_version_without_the_rounding():
    """The model's online softmax over tiles is the plain version's
    softmax: with p kept in f32 both agree to f32 rounding, so what the
    test above measures is the bf16 p alone."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 40, 32),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 300, 32),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 300, 32),
                                             dtype=np.float32))
    got = _tc_model(q, k, v, q_offset=260, block_k=64, p_dtype=F32)
    want = flash_attention_ref(q, k, v, q_offset=260)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
