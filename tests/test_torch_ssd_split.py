"""A plain model of the CUDA SSD scan's arithmetic, on the CPU.

``csrc/ssd_scan.cu`` computes the reference's chunked scan in four
chunk-parallel passes (C B^T per (b, chunk); cs and each chunk's own state
S_c; the state passing; the outputs), every sum in the plain version's
order in float32.  The card is not here, so this file holds a model of
that arithmetic in plain PyTorch and shows:

(a) the four passes, with float32 products, give ``ssd_chunked_ref``'s
    y and final state bit for bit: the same operations in the same order
    (the state recurrence is the reference's own update), only regrouped;
(b) the products on the tensor cores instead, in TF32: with TF32
    rounding emulated as ``cvt.rna.tf32.f32`` does it (add 0x1000 to the
    bits, clear the low 13), split three ways (3xTF32) they hold the
    kernel check's ``|got - want| <= 1e-4 + 1e-4 |want|`` (``chip_smoke.py``
    ``SSD_TOL``) at mamba2-like and serve-like magnitudes over several
    chunks, and one TF32 product does not.  Neither is exact, and the
    serve check needs the plain version's bits (a 64-layer Mamba2 stack
    moves its logits by several per cent for a 1e-7 relative change of the
    scan's output; ``python -m repro_torch.ssd_sensitivity`` measures
    it): so the kernel sums in float32 FMAs;
(c) the wrapper's host plan of the kernels' scratch raises on a chunk
    length or state size above the kernels' limits.

The split model sums the three products of a split one after the other
over the whole depth, where tensor cores sum eight terms a step; the
card's own check is ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ref import ssd_chunk_len, ssd_chunked_ref

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

TOL = 1e-4
#: tests/test_torch_ssd.py's cases and test_ssd_chunked_ref's extra one.
CASES = [(1, 128, 2, 32, 16, 32), (2, 256, 4, 64, 64, 128),
         (1, 64, 8, 16, 32, 64), (2, 45, 3, 16, 8, 128),
         (2, 128, 4, 32, 32, 16)]


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from
    zero (finite float32 inputs)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def einsum_f32(spec, a, b):
    return torch.einsum(spec, a, b)


def einsum_3xtf32(spec, a, b):
    """a*b in 3xTF32: a = hi + lo, b = hi + lo, lo*hi + hi*lo + hi*hi,
    the small terms first, in float32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)) \
        + torch.einsum(spec, ah, bh)


def einsum_1xtf32(spec, a, b):
    return torch.einsum(spec, tf32(a), tf32(b))


def ssd_passes(x, dt, A, B_, C_, chunk, prod=einsum_f32):
    """The kernel's four passes, each product through ``prod``."""
    Bb, T, H, P = x.shape
    N = B_.shape[-1]
    L = ssd_chunk_len(T, chunk)
    nc = T // L
    f32 = torch.float32
    xc = x.to(f32).reshape(Bb, nc, L, H, P)
    dtc = dt.to(f32).reshape(Bb, nc, L, H)
    Bc = B_.to(f32).reshape(Bb, nc, L, N)
    Cc = C_.to(f32).reshape(Bb, nc, L, N)
    A = A.to(f32)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    # 1. ssd_cb_kernel: C B^T per (b, chunk), shared by the heads
    CB = [prod("bln,bmn->blm", Cc[:, c], Bc[:, c]) for c in range(nc)]
    # 2. ssd_state_kernel: cs in order, each chunk's own state
    cs, dtx, S = [], [], []
    for c in range(nc):
        cs.append(torch.cumsum(dtc[:, c] * A, dim=1))          # (B,L,H)
        dtx.append(dtc[:, c][..., None] * xc[:, c])            # (B,L,H,P)
        w = torch.exp(cs[c][:, -1, :][:, None, :] - cs[c])     # (B,L,H)
        S.append(prod("blnh,blhp->bhnp", Bc[:, c][..., None]
                      * w[:, :, None], dtx[c]))
    # 3. ssd_pass_kernel: the state each chunk starts from, the final one
    state = torch.zeros((Bb, H, N, P), dtype=f32)
    S_in = []
    for c in range(nc):
        S_in.append(state)
        state = torch.exp(cs[c][:, -1, :])[:, :, None, None] * state + S[c]
    # 4. ssd_out_kernel: y
    ys = []
    for c in range(nc):
        diff = cs[c][:, :, None, :] - cs[c][:, None, :, :]     # (B,L,L,H)
        decay = torch.exp(diff.masked_fill(~tri[None, :, :, None],
                                           float("-inf")))
        y_intra = prod("blmh,bmhp->blhp", CB[c][..., None] * decay, dtx[c])
        y_inter = prod("bln,bhnp->blhp", Cc[:, c], S_in[c]) \
            * torch.exp(cs[c])[..., None]
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(Bb, T, H, P), state


def _inputs(seed, B, T, H, P, N, serve=False):
    """tests/test_torch_cuda.py's distributions, or serve-like ones: x, B,
    C through silu as the Mamba2 block hands them over, ``A`` from -1 to
    -16 (the port's ``A_log`` init), dt about 1 (its ``dt_bias``)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    if serve:
        silu = torch.nn.functional.silu
        dt = torch.nn.functional.softplus(0.5 * r(B, T, H)
                                          + float(np.log(np.e - 1)))
        return (silu(r(B, T, H, P)), dt,
                -torch.linspace(1.0, 16.0, H), silu(r(B, T, N)),
                silu(r(B, T, N)))
    return (r(B, T, H, P), torch.nn.functional.softplus(r(B, T, H)),
            -torch.exp(0.3 * r(H)), r(B, T, N) / N ** 0.5,
            r(B, T, N) / N ** 0.5)


def _share(got, want):
    """The largest |got - want| / (1e-4 + 1e-4 |want|): above 1 fails."""
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


@pytest.mark.parametrize("B,T,H,P,N,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_four_passes_are_the_chunked_scan_bit_for_bit(B, T, H, P, N,
                                                          chunk, dtype):
    x, dt, A, Bm, Cm = _inputs(B * T + N, B, T, H, P, N)
    low = getattr(torch, dtype)
    args = (x.to(low), dt, A, Bm.to(low), Cm.to(low))
    got_y, got_s = ssd_passes(*args, chunk)
    want_y, want_s = ssd_chunked_ref(*args, chunk)
    assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("serve", [False, True], ids=["mamba2-like",
                                                      "serve-like"])
def test_3xtf32_holds_the_tolerance_and_one_tf32_product_does_not(serve):
    """B = 1, T = 1024 (8 chunks of 128), 8 heads, P = 64, N = 128."""
    args = _inputs(19, 1, 1024, 8, 64, 128, serve=serve)
    want_y, want_s = ssd_chunked_ref(*args, 128)
    y3, s3 = ssd_passes(*args, 128, prod=einsum_3xtf32)
    y1, s1 = ssd_passes(*args, 128, prod=einsum_1xtf32)
    assert max(_share(y3, want_y), _share(s3, want_s)) < 1.0
    assert max(_share(y1, want_y), _share(s1, want_s)) > 1.0


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                    # a TF32 value: kept
    half = 2.0 ** -11                         # half a TF32 ulp at 1.0
    a = torch.tensor([one, 1.0 + half, -(1.0 + half), 1.0 + half / 2,
                      3.0e-39], dtype=torch.float32)
    want = torch.tensor([one, one, -one, 1.0, 3.0e-39], dtype=torch.float32)
    assert torch.equal(tf32(a)[:4], want[:4])
    assert float(tf32(a)[4]) == pytest.approx(3.0e-39, rel=2 ** -10)
    # the split is exact where the low part fits TF32 and a - hi is exact
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000, dtype=np.float32))
    hi = tf32(v)
    assert torch.equal(hi + (v - hi), v)


def test_the_host_plan_sizes_the_scratch_and_raises_past_the_limits():
    plan = tssd._plan(1, 4096, 80, 64, 128, 128)
    assert plan == {"cbt": (1, 32, 128 * 128), "ct": (1, 32, 128 * 128),
                    "cs": (1, 80, 32, 128), "st": (1, 80, 32, 128, 64)}
    assert tssd._plan(2, 90, 3, 72, 20, 45)["ct"] == (2, 2, 20 * 45)
    assert list(tssd._plan(1, 8, 1, 1, 1, 8)) == \
        [f for f, _ in tssd.SsdArgs._fields_[7:11]]
    with pytest.raises(ValueError, match="chunk length 256 .at most 128"):
        tssd._plan(1, 512, 2, 8, 16, 256)
    with pytest.raises(ValueError, match="state size 129 .at most 128"):
        tssd._plan(1, 128, 2, 8, 129, 128)
    # the CPU route runs the plain version, which has no such limit
    x, dt, A, Bm, Cm = _inputs(5, 1, 256, 2, 8, 16)
    y, s = tssd.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    want_y, want_s = ssd_chunked_ref(x, dt, A, Bm, Cm, 256)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
