"""The port's Mamba2 SSD scan against the JAX reference on the CPU.

On the CPU ``repro_torch.kernels.ssd_scan.ssd_scan`` (and its model-layout
wrapper ``kernels.ops.ssd_scan``) runs the plain version,
``kernels.ref.ssd_chunked_ref``.  Here it is held against the reference's
Pallas kernel run as its own tests run it, in interpret mode, on every
case of ``tests/test_kernels.py``'s SSD test and on a ragged chunk (T = 45
< 128: L = 45), in f32 and bf16; ``ssd_chunked_ref`` against the model's
``repro.models.ssm.ssd_chunked`` (y and final state); the port's
sequential ``ssd_ref`` against the reference's.  Tolerances are the
reference's own (``tests/test_kernels.py:105``, ``:123``): 1e-4 in f32
(observed: 1.2e-5 at most, summation order and ``exp`` of differences of
cumulative sums), 5e-2 in bf16 (one bf16 rounding of y: 3.9e-3
observed).  The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as ssd_raw
from repro.models.ssm import ssd_chunked as j_ssd_chunked

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_ref
from repro_torch.models import ssm as TS

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: tests/test_kernels.py:89-94, and a ragged chunk with an odd L.
CASES = [(1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 64, 128),
         (1, 64, 8, 16, 32, 64), (2, 45, 3, 16, 8, 128)]


def _inputs(seed, B, T, H, P, N, dtype):
    """x, dt, A, B, C from a numpy seed, with the reference test's
    distributions: (jax arrays, torch tensors), x/B/C rounded to the same
    bf16 values on both sides."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H), dtype=np.float32)))
    A = -np.exp(rng.standard_normal(H, dtype=np.float32) * 0.3)
    Bm = rng.standard_normal((B, T, N), dtype=np.float32) / np.sqrt(N)
    Cm = rng.standard_normal((B, T, N), dtype=np.float32) / np.sqrt(N)
    arrs = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]
    low = (dtype, "float32", "float32", dtype, dtype)
    j = [jnp.asarray(a).astype(d) for a, d in zip(arrs, low)]
    t = [torch.from_numpy(a).to(getattr(torch, d)) for a, d in zip(arrs, low)]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,T,H,P,N,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_the_pallas_kernel(B, T, H, P, N, chunk, dtype):
    j, t = _inputs(B * T + N, B, T, H, P, N, dtype)
    want = ssd_raw(*j, chunk=chunk, interpret=True)
    tssd.reset_launches()
    got, state = tssd.ssd_scan(*t, chunk=chunk)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    assert state.dtype == torch.float32 and state.shape == (B, H, N, P)
    _close(got, want, TOL[dtype])
    y = tops.ssd_scan(*t, chunk=chunk)
    assert torch.equal(y, got)
    assert tssd.launches["ssd_scan"] == 0   # CPU tensors: the plain version
    # the sequential oracle, y and final state
    want_y, want_s = jref.ssd_ref(*j)
    _close(got, want_y, TOL[dtype])
    _close(state, want_s, TOL[dtype])


@pytest.mark.parametrize("B,T,H,P,N,chunk", CASES + [(2, 128, 4, 32, 32,
                                                      16)])
def test_ssd_chunked_ref_matches_the_model_ssd_chunked(B, T, H, P, N, chunk):
    """y and final state of the model's jnp chunked scan, and the model
    wrapper (``models.ssm.ssd_chunked``: y in f32 from bf16 x)."""
    j, t = _inputs(7 + T, B, T, H, P, N, "float32")
    want_y, want_s = j_ssd_chunked(*j, chunk)
    got_y, got_s = ssd_chunked_ref(*t, chunk)
    assert got_y.dtype == got_s.dtype == torch.float32
    _close(got_y, want_y, TOL["float32"])
    _close(got_s, want_s, TOL["float32"])
    j, t = _inputs(7 + T, B, T, H, P, N, "bfloat16")
    want_y, want_s = j_ssd_chunked(*j, chunk)
    got_y, got_s = TS.ssd_chunked(*t, chunk)
    assert got_y.dtype == torch.float32
    _close(got_y, want_y, TOL["float32"])
    _close(got_s, want_s, TOL["float32"])


def test_ssd_ref_matches_the_references_oracle():
    j, t = _inputs(3, 2, 40, 3, 8, 16, "float32")
    want_y, want_s = jref.ssd_ref(*j)
    got_y, got_s = ssd_ref(*t)
    _close(got_y, want_y, 1e-5)
    _close(got_s, want_s, 1e-5)


def test_t_not_a_multiple_of_the_chunk_raises_naming_the_lengths():
    _, t = _inputs(0, 1, 200, 2, 8, 8, "float32")
    for call in (lambda: tssd.ssd_scan(*t, chunk=128),
                 lambda: tops.ssd_scan(*t, chunk=128),
                 lambda: ssd_chunked_ref(*t, 128),
                 lambda: TS.ssd_chunked(*t, 128)):
        with pytest.raises(ValueError, match="T = 200 .* L = .* = 128"):
            call()
    with pytest.raises(AssertionError):      # the reference asserts too
        j, _ = _inputs(0, 1, 200, 2, 8, 8, "float32")
        j_ssd_chunked(*j, 128)


def test_dispatch_by_device_and_argument_checks():
    """CPU tensors run the plain version and count no launch; a device
    with no kernel raises; malformed arguments raise before either."""
    _, t = _inputs(1, 1, 32, 2, 8, 8, "float32")
    tssd.reset_launches()
    y, s = tssd.ssd_scan(*t, chunk=16)
    want_y, want_s = ssd_chunked_ref(*t, 16)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert tssd.launches["ssd_scan"] == 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tssd.ssd_scan(*[a.to("meta") for a in t], chunk=16)
    with pytest.raises(ValueError, match="different devices"):
        tssd.ssd_scan(t[0].to("meta"), *t[1:], chunk=16)
    with pytest.raises(ValueError, match="does not fit"):
        tssd.ssd_scan(t[0], t[1][:, :16], *t[2:], chunk=16)
    with pytest.raises(TypeError, match="float16"):
        tssd.ssd_scan(t[0].half(), *t[1:], chunk=16)
    with pytest.raises(TypeError):
        tssd.ssd_scan(t[0], t[1], t[2], t[3], t[4].bfloat16(), chunk=16)
