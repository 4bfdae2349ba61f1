"""Algorithm 2 — STrack adaptive load balancing, batched over flows.

The port of ``repro.core.lb``.  ``bitmap[f, p] == 1`` means entropy ``p``
of flow ``f`` returned an ECN-marked ACK; CHOOSE_PATH round-robins across
the first ``min(max_paths, max(8, 2*cwnd))`` entropies, skipping marked
ones, and clears the first skipped mark ("one packet only clears one
bit").
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..numerics import f32
from .params import STrackParams


class SprayState(NamedTuple):
    bitmap: torch.Tensor         # int8[N, max_paths], 1 = ECN-marked (bad)
    rr: torch.Tensor             # int32[N], round-robin pointer
    next_path_id: torch.Tensor   # int32[N], -1 = invalid
    last_reset_ts: torch.Tensor  # float32[N]


def init_spray(p: STrackParams, n: int, device, now: float = 0.0
               ) -> SprayState:
    return SprayState(
        bitmap=torch.zeros((n, p.max_paths), dtype=torch.int8, device=device),
        rr=torch.zeros((n,), dtype=torch.int32, device=device),
        next_path_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        last_reset_ts=torch.full((n,), f32(now), dtype=torch.float32,
                                 device=device),
    )


def update_ecn_bitmap(s: SprayState, ecn: torch.Tensor,
                      path_id: torch.Tensor) -> SprayState:
    """UPDATE_ECN_BITMAP(ecn, path_id); an out-of-range path id leaves the
    bitmap alone (the reference's dropped out-of-bounds update)."""
    n, paths = s.bitmap.shape
    cols = torch.arange(paths, device=s.bitmap.device, dtype=torch.int32)
    hit = cols[None, :] == path_id[:, None]
    bitmap = torch.where(hit, ecn.to(torch.int8)[:, None], s.bitmap)
    next_path_id = torch.where(ecn, -1, path_id).to(torch.int32)
    return s._replace(bitmap=bitmap, next_path_id=next_path_id)


def choose_path(s: SprayState, p: STrackParams, cwnd_pkts: torch.Tensor,
                now: float) -> tuple[torch.Tensor, SprayState]:
    """CHOOSE_PATH() -> (entropy[N], new_state)."""
    now = f32(now)
    n, P = s.bitmap.shape
    dev = s.bitmap.device
    do_reset = (now - s.last_reset_ts) > f32(p.bitmap_reset_rtts
                                             * p.base_rtt_us)
    bitmap = torch.where(do_reset[:, None], torch.zeros_like(s.bitmap),
                         s.bitmap)
    last_reset_ts = torch.where(do_reset, now, s.last_reset_ts)

    paths = torch.clamp((2.0 * cwnd_pkts).to(torch.int32), 8, p.max_paths)
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    idx = (s.rr[:, None] + 1 + ar[None, :]) % paths[:, None]
    c0 = idx[:, 0]
    c0_marked = bitmap.gather(1, c0[:, None].long())[:, 0] != 0
    bitmap_cleared = torch.where(ar[None, :] == c0[:, None],
                                 torch.zeros_like(bitmap), bitmap)
    unmarked = bitmap_cleared.gather(1, idx.long()) == 0
    unmarked[:, 0] = False
    k = unmarked.to(torch.uint8).argmax(1)
    scanned = torch.where(c0_marked, idx.gather(1, k[:, None])[:, 0], c0)

    pinned = s.next_path_id >= 0
    rr_new = torch.where(pinned, s.next_path_id, scanned).to(torch.int32)
    new_bitmap = torch.where(pinned[:, None], bitmap, bitmap_cleared)
    return rr_new, SprayState(
        bitmap=new_bitmap,
        rr=rr_new,
        next_path_id=torch.full_like(s.next_path_id, -1),
        last_reset_ts=last_reset_ts,
    )
