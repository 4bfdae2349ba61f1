"""The SSD scan's gradient on the CPU: the plain chunked scan's autograd
against ``jax.grad`` of the reference model's ``ssd_chunked``, the
backward kernel's algorithm (its five passes, modelled in plain PyTorch)
against autograd, and ``SsdScanFn``'s plumbing.

The reference trains the SSD through XLA's gradient of the jnp
``ssd_chunked`` (``src/repro/models/ssm.py:72``); the port's plain twin is
autograd through ``ssd_chunked_ref``, and on the card
``kernels/csrc/ssd_scan.cu``'s ``ssd_scan_bwd`` (held against the twin by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 11).  Tolerance:
1e-4 of each gradient's largest magnitude (``SSD_TOL["float32"]``), one
float32 summation order against another.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS

from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_chunked_ref

pytestmark = [pytest.mark.tier1, pytest.mark.torch]

TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")
CASES = [  # B, T, H, P, N, chunk
    (2, 32, 3, 16, 16, 16),
    (1, 40, 2, 5, 7, 8),
    (2, 24, 4, 8, 4, 24),
    (1, 64, 2, 64, 32, 32),
    # H not a multiple of the head group: kernel_model runs in float64,
    # where the order of the groups' sum cannot change a result, so this
    # case checks the model's slicing into groups; the float32 order at
    # the kernel's group boundaries is held on the card by
    # tests/test_torch_cuda.py's (1, 64, 13, 8, 12, 32) and H 80 cases.
    (1, 32, 13, 8, 8, 16),
]


def _inputs(B, T, H, P, N, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, T, H, P)).astype(f)
    dt = (rng.random((B, T, H)) * 0.5 + 0.05).astype(f)
    A = (-np.exp(rng.uniform(0.0, np.log(16.0), H))).astype(f)
    Bm = rng.standard_normal((B, T, N)).astype(f)
    Cm = rng.standard_normal((B, T, N)).astype(f)
    dy = rng.standard_normal((B, T, H, P)).astype(f)
    dfin = rng.standard_normal((B, H, N, P)).astype(f)
    return x, dt, A, Bm, Cm, dy, dfin


def _close(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= TOL, (what, name, rel)


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_ssd_gradients_match_jax(case, with_final):
    B, T, H, P, N, chunk = case
    x, dt, A, Bm, Cm, dy, dfin = _inputs(B, T, H, P, N, sum(case))

    def loss(*ins):
        y, st = JS.ssd_chunked(*ins, chunk)
        out = jnp.sum(y * dy)
        return out + jnp.sum(st * dfin) if with_final else out
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    t = lambda a: torch.from_numpy(a)
    got = ssd.ssd_scan_bwd_plain(t(dy), *(t(a) for a in (x, dt, A, Bm, Cm)),
                                 chunk, t(dfin) if with_final else None)
    _close([g.numpy() for g in got], [np.asarray(w) for w in want],
           (case, with_final))


def kernel_model(x, dt, A, Bm, Cm, chunk, dy, dfinal=None):
    """The backward kernel's algorithm (``csrc/ssd_scan.cu``, the comment
    above ``SsdBwdArgs``) in plain PyTorch, float64, pass by pass: the
    forward's chunk states S_in; Q_c and the reverse pass G_c (b1, b2); per
    (b, chunk, group of ``HEAD_GROUP`` heads) DY, W and E's sums, W summed
    over the group's heads (b3); per head w o (B G_c) + M^T dy, u, ddtx . x
    and exp(cs) dy . (C S_in), dcs, dlam, ddt, dx and dA's part (b4); the
    groups' W summed and its products with B and C, then the carried-state
    terms as one product per (b, chunk) over K = H P (b5)."""
    f = torch.float64
    x, dt, A, Bm, Cm, dy = (t.to(f) for t in (x, dt, A, Bm, Cm, dy))
    Bb, T, H, P = x.shape
    N, L = Bm.shape[-1], min(chunk, T)
    nc = T // L
    xc, dtc = x.reshape(Bb, nc, L, H, P), dt.reshape(Bb, nc, L, H)
    Bc, Cc = Bm.reshape(Bb, nc, L, N), Cm.reshape(Bb, nc, L, N)
    dyc = dy.reshape(Bb, nc, L, H, P)
    cs = torch.cumsum(dtc * A, dim=2)
    dtx = dtc[..., None] * xc
    cl = cs[:, :, -1:, :]
    w = torch.exp(cl - cs)                                 # (B,nc,L,H)
    s_in = torch.zeros(Bb, nc, H, N, P, dtype=f)
    s = torch.zeros(Bb, H, N, P, dtype=f)
    for c in range(nc):
        s_in[:, c] = s
        s = torch.exp(cl[:, c, 0])[..., None, None] * s + torch.einsum(
            "bln,blh,blhp->bhnp", Bc[:, c], w[:, c], dtx[:, c])
    # b1, b2
    q = torch.einsum("bcln,bclh,bclhp->bchnp", Cc, torch.exp(cs), dyc)
    g = torch.zeros(Bb, nc, H, N, P, dtype=f)
    cur = (torch.zeros(Bb, H, N, P, dtype=f) if dfinal is None
           else dfinal.to(f))
    for c in range(nc - 1, -1, -1):
        g[:, c] = cur
        cur = torch.exp(cl[:, c, 0])[..., None, None] * cur + q[:, c]
    # b3: W of each head, summed over a group of heads in head order
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (B,nc,L,L,H)
    D = torch.where(tri[..., None], torch.exp(diff.clamp_max(0)), 0.0)
    CB = torch.einsum("bcln,bcmn->bclm", Cc, Bc)[..., None]
    W = torch.einsum("bclhp,bcmhp->bclmh", dyc, dtx) * D
    E = W * CB
    dcs = E.sum(3) - E.sum(2)                              # (B,nc,L,H)
    G = ssd.HEAD_GROUP
    wg = torch.stack([W[..., h0:h0 + G].sum(-1)
                      for h0 in range(0, H, G)], 2)        # (B,nc,ng,L,L)
    # b4: per head
    bg = torch.einsum("bcmn,bchnp->bcmhp", Bc, g) * w[..., None]
    u = (bg * dtx).sum(-1)
    M = CB * D
    ddtx = bg + torch.einsum("bclmh,bclhp->bcmhp", M, dyc)
    y_in = torch.einsum("bcln,bchnp->bclhp", Cc, s_in)
    dcs = dcs + torch.exp(cs) * (dyc * y_in).sum(-1) - u
    dcs[:, :, -1] += (torch.exp(cl[:, :, 0])
                      * (g * s_in).sum((-1, -2)) + u.sum(2))
    dlam = torch.flip(torch.cumsum(torch.flip(dcs, [2]), 2), [2])
    ddt = dlam * A + (ddtx * xc).sum(-1)
    dx = dtc[..., None] * ddtx
    dA = (dlam * dtc).sum((0, 1, 2))
    # b5: the groups' W, then K = H P products shared by every head
    ws = wg.sum(2)
    ey = (torch.exp(cs)[..., None] * dyc).reshape(Bb, nc, L, H * P)
    wx = ((w * dtc)[..., None] * xc).reshape(Bb, nc, L, H * P)
    s_k = s_in.permute(0, 1, 3, 2, 4).reshape(Bb, nc, N, H * P)
    g_k = g.permute(0, 1, 3, 2, 4).reshape(Bb, nc, N, H * P)
    dC = (torch.einsum("bclm,bcmn->bcln", ws, Bc)
          + torch.einsum("bclk,bcnk->bcln", ey, s_k))
    dB = (torch.einsum("bclm,bcln->bcmn", ws, Cc)
          + torch.einsum("bcmk,bcnk->bcmn", wx, g_k))
    return (dx.reshape(x.shape), ddt.reshape(dt.shape), dA,
            dB.reshape(Bm.shape), dC.reshape(Cm.shape))


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_kernel_algorithm_matches_autograd(case, with_final):
    B, T, H, P, N, chunk = case
    ins = [torch.from_numpy(a) for a in _inputs(B, T, H, P, N, 7 + sum(case))]
    x, dt, A, Bm, Cm, dy, dfin = ins
    dfin = dfin if with_final else None
    got = kernel_model(x, dt, A, Bm, Cm, chunk, dy, dfin)
    want = ssd.ssd_scan_bwd_plain(dy, x, dt, A, Bm, Cm, chunk, dfin)
    _close([g.numpy() for g in got], [w.numpy() for w in want],
           (case, with_final))


def test_ssd_scan_fn_on_the_cpu_is_the_plain_scan():
    """SsdScanFn on CPU tensors: the plain forward, and the plain twin as
    its backward, equal autograd through the plain scan (the final state's
    gradient used where the loss reads it)."""
    x, dt, A, Bm, Cm, dy, dfin = (torch.from_numpy(a)
                                  for a in _inputs(2, 32, 3, 16, 16, 5))
    outs = []
    for fn in (lambda *a: ssd.SsdScanFn.apply(*a, 16),
               lambda *a: ssd_chunked_ref(*a, 16)):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y, st = fn(*ins)
        loss = (y * dy).sum() + (st * dfin).sum()
        outs.append((y.detach(), torch.autograd.grad(loss, ins)))
    (y1, g1), (y2, g2) = outs
    assert torch.equal(y1, y2)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_plan_limits():
    plan = ssd._bwd_plan(4, 1024, 80, 64, 128, 128)
    assert plan == {"gs": (4, 80, 8, 128, 64), "dcs": (4, 80, 8, 128),
                    "wg": (4, 8, 8, 128, 128), "dAp": (4, 80, 8)}
    assert ssd._bwd_plan(1, 32, 13, 8, 8, 16)["wg"] == (1, 2, 2, 16, 16)
    for shape in ((1, 64, 2, 65, 16, 16), (1, 256, 2, 16, 129, 128),
                  (1, 512, 2, 16, 16, 256)):
        with pytest.raises(ValueError, match="backward kernel"):
            ssd._bwd_plan(*shape)


def test_head_group_mirrors_the_kernel():
    """The wrapper sizes the group partials of W with the kernel's own
    ``HEAD_GROUP``."""
    import re
    from pathlib import Path
    text = (Path(ssd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    assert int(re.search(r"constexpr int HEAD_GROUP = (\d+);", text)
               .group(1)) == ssd.HEAD_GROUP


def test_backward_kernel_needs_the_forward_scratch():
    """The CUDA route refuses a call without the forward's scratch (the
    CPU route, the plain twin, needs none)."""
    x, dt, A, Bm, Cm, dy, _ = (torch.from_numpy(a)
                               for a in _inputs(1, 16, 2, 4, 4, 3))
    got = ssd.ssd_scan_bwd(dy, x, dt, A, Bm, Cm, 8)
    want = ssd.ssd_scan_bwd_plain(dy, x, dt, A, Bm, Cm, 8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    real = ssd.route
    ssd.route = lambda t: "cuda"
    try:
        with pytest.raises(ValueError, match="scratch"):
            ssd.ssd_scan_bwd(dy, x, dt, A, Bm, Cm, 8)
    finally:
        ssd.route = real
