"""The port's flash attention against the reference's Pallas kernel.

On the CPU ``repro_torch.kernels.flash_attention.flash_attention`` (and
its model-layout wrapper ``kernels.ops.flash_attention``) runs the plain
version, ``kernels.ref.flash_attention_ref``; here it is held against the
reference's kernel run as its own tests run it, in interpret mode, on
every case of ``tests/test_kernels.py``'s flash-attention tests, in f32
(2e-5), bf16 (2e-2: one bf16 rounding of the output) and f32 queries
against a bf16 KV cache (2e-5).  The CUDA kernel is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as fa_raw
from repro.models.layers import _sdpa_chunked

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import flash_attention_ref

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

#: (q dtype, kv dtype, tolerance) by name.
DTYPES = {"f32": ("float32", "float32", 2e-5),
          "bf16": ("bfloat16", "bfloat16", 2e-2),
          "f32q_bf16kv": ("float32", "bfloat16", 2e-5)}


def _inputs(seed, q_shape, kv_shape, dtype):
    """q, k, v from a numpy seed: (jax arrays, torch tensors), rounded to
    the same bf16 values on both sides."""
    qd, kvd, tol = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    dts = (qd, kvd, kvd)
    j = [jnp.asarray(a).astype(d) for a, d in zip(arrs, dts)]
    t = [torch.from_numpy(a).to(getattr(torch, d)) for a, d in zip(arrs, dts)]
    return j, t, tol


def _close(got: torch.Tensor, want, tol):
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,K,Tq,Tk,hd", [
    (1, 4, 4, 128, 128, 64),       # MHA, single block
    (2, 8, 2, 256, 256, 64),       # GQA 4:1, multi-block
    (1, 4, 1, 128, 384, 128),      # MQA, rectangular
    (2, 2, 2, 100, 100, 32),       # ragged (non-multiple of block)
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_causal(B, H, K, Tq, Tk, hd, dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(0, (B, H, Tq, hd), (B, K, Tk, hd),
                                           dtype)
    want = fa_raw(jq, jk, jv, causal=True, block_q=128, block_k=128)
    _close(tfa.flash_attention(q, k, v, causal=True), want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_non_causal(dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(1, (1, 2, 64, 64), (1, 2, 192, 64),
                                           dtype)
    want = fa_raw(jq, jk, jv, causal=False, block_q=64, block_k=64)
    _close(tfa.flash_attention(q, k, v, causal=False), want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_sliding_window(dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(2, (1, 2, 256, 64),
                                           (1, 2, 256, 64), dtype)
    want = fa_raw(jq, jk, jv, causal=True, window=96, block_q=64, block_k=64)
    _close(tfa.flash_attention(q, k, v, causal=True, window=96), want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_decode_offset(dtype):
    """Decode: 1 query at absolute position q_offset against a long cache."""
    (jq, jk, jv), (q, k, v), tol = _inputs(3, (2, 4, 1, 64), (2, 2, 512, 64),
                                           dtype)
    want = fa_raw(jq, jk, jv, causal=True, q_offset=300, block_q=1,
                  block_k=128)
    _close(tfa.flash_attention(q, k, v, causal=True, q_offset=300), want, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_ops_layout(dtype):
    """ops wrapper uses the model layout (B, T, H, hd), in both packages."""
    (jq, jk, jv), (q, k, v), tol = _inputs(4, (2, 128, 4, 64),
                                           (2, 128, 2, 64), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True)
    _close(tops.flash_attention(q, k, v, causal=True), want, tol)


def test_kernel_vs_model_attention():
    """Flash attention vs the reference model's chunked JAX attention."""
    (jq, jk, jv), (q, k, v), _ = _inputs(6, (2, 256, 8, 64), (2, 256, 2, 64),
                                         "f32")
    pos = jnp.broadcast_to(jnp.arange(256, dtype=jnp.int32)[None], (2, 256))
    want = _sdpa_chunked(jq, jk, jv, pos, pos, True, None, 64)
    _close(tops.flash_attention(q, k, v, causal=True), want, 2e-4)


def test_queries_with_no_live_key_give_zero():
    """A query with no live key returns 0, as the Pallas kernel's
    max(l, 1e-20) gives: a negative q_offset puts the first queries before
    key 0."""
    (jq, jk, jv), (q, k, v), _ = _inputs(7, (1, 2, 8, 16), (1, 2, 8, 16),
                                         "f32")
    got = tfa.flash_attention(q, k, v, causal=True, q_offset=-4)
    want = fa_raw(jq, jk, jv, causal=True, q_offset=-4, block_q=8,
                  block_k=8)
    _close(got, want, 2e-5)
    assert torch.equal(got[:, :, :4], torch.zeros_like(got[:, :, :4]))
    assert got[:, :, 4:].abs().amax() > 0


def test_wrapper_checks_and_dispatch():
    """CPU tensors run the plain version and count no launch; a device
    with no kernel raises instead of reaching the plain version; bad
    shapes and types are refused."""
    _, (q, k, v), _ = _inputs(8, (1, 4, 8, 16), (1, 2, 8, 16), "f32")
    tfa.reset_launches()
    got = tfa.flash_attention(q, k, v)
    assert torch.equal(got, flash_attention_ref(q, k, v))
    assert tfa.launches["flash_attention"] == 0
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfa.flash_attention(*meta)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :, :4], v)            # k/v shapes differ
    with pytest.raises(ValueError):
        tfa.flash_attention(q[:, :3], k, v)               # H % K != 0
    with pytest.raises(TypeError):
        tfa.flash_attention(q.double(), k, v)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, window=0)
