"""Global map archive + landmark resurrection.

Port of ``sadvio_tpu/data/globalmap.py``.  The archive is a fixed-capacity
ring of landmark positions + BRIEF descriptors on the caller's device;
resurrection is one batched projection + descriptor match.  A re-activated
landmark re-enters the sliding window with its archived position.

Scatters write through a dump row (index = capacity) for masked entries, so
no write lands on a live row by accident and none depends on the order in
which a CUDA scatter applies duplicates: ``archive`` gives every live entry
its own ring slot, and ``resurrect`` keeps, for a detection that two archive
rows claim, the row with the smallest descriptor distance (the lower row on
a tie).  ``match``'s mutual-best check already yields at most one archive
row per detection; the rule is stated so the result does not rest on that.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sadvio_tpu_torch.frontend import match as match_mod
from sadvio_tpu_torch.frontend.detect import DESC_BITS
from sadvio_tpu_torch.models import cameras
from sadvio_tpu_torch.utils.struct import Struct


@dataclass
class GlobalMap(Struct):
    """Fixed-capacity archive ring."""

    pos: torch.Tensor  # (A,3) world positions
    desc: torch.Tensor  # (A,256) bool BRIEF descriptors
    mask: torch.Tensor  # (A,)
    head: torch.Tensor  # () int64 ring cursor
    src: torch.Tensor  # (A,) int64 index of the archiving keyframe in the host-side
    #                    archived_kf log, -1 where unknown (loop-closure provenance)

    @classmethod
    def create(cls, capacity: int = 4096, device=None):
        return cls(pos=torch.zeros((capacity, 3), device=device),
                   desc=torch.zeros((capacity, DESC_BITS), dtype=torch.bool, device=device),
                   mask=torch.zeros(capacity, dtype=torch.bool, device=device),
                   head=torch.zeros((), dtype=torch.int64, device=device),
                   src=torch.full((capacity,), -1, dtype=torch.int64, device=device))

    @property
    def capacity(self):
        return self.pos.shape[0]


def put_rows(x, slot, val):
    """Copy of x with x[slot] = val; rows of slot equal to len(x) are dropped."""
    pad = torch.zeros((1, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]).index_put((slot,), val)[: x.shape[0]]


def archive(gm: GlobalMap, pos, desc, alive, src_idx=None) -> GlobalMap:
    """Append the landmarks with ``alive`` set into the ring.

    src_idx: optional index of the archiving keyframe in the host-side
    archived_kf log, stored per landmark so a later resurrection can name
    the revisited keyframe."""
    A = gm.capacity
    n = pos.shape[0]
    if n > A:
        raise ValueError(f"archive: {n} landmarks do not fit a ring of {A}")
    rank = torch.cumsum(alive.long(), 0) - 1
    slot = torch.where(alive, (gm.head + rank) % A, A)
    src_val = torch.full((n,), -1 if src_idx is None else int(src_idx), dtype=torch.int64,
                         device=pos.device)
    return gm.replace(pos=put_rows(gm.pos, slot, pos), desc=put_rows(gm.desc, slot, desc),
                      mask=put_rows(gm.mask, slot, torch.ones_like(alive)),
                      src=put_rows(gm.src, slot, src_val), head=(gm.head + alive.sum()) % A)


def resurrect(gm: GlobalMap, cam, R_w_f, t_w_f, R_f_s, t_f_s, det_uv, det_desc, det_valid, *,
              search_px=12.0, max_dist=60.0):
    """Re-associate archived landmarks with fresh detections.

    Archived landmarks whose projection under the given pose lands within
    ``search_px`` of a detection with a matching descriptor are returned per
    detection: (lmk_of_det (N,3), hit (N,) bool, src_of_det (N,) int64, -1
    where no hit)."""
    uv_proj, vis = cameras.project_world(cam, R_w_f, t_w_f, R_f_s, t_f_s, gm.pos)
    idx, dist = match_mod.match(gm.desc, uv_proj, gm.mask & vis, det_desc, det_uv, det_valid,
                                search_radius=search_px, max_dist=max_dist)
    N, A = det_uv.shape[0], gm.capacity
    matched = idx >= 0
    det = torch.where(matched, idx, N)
    # per detection, the claiming archive row of smallest distance (lowest row on ties)
    best_d = torch.full((N + 1,), float("inf"), device=dist.device).scatter_reduce(
        0, det, torch.where(matched, dist, float("inf")), reduce="amin")
    rows = torch.arange(A, device=det.device)
    cand = torch.where(matched & (dist == best_d[det]), rows, A)
    row = torch.full((N + 1,), A, dtype=torch.int64, device=det.device).scatter_reduce(
        0, det, cand, reduce="amin")[:N]
    hit = row < A
    safe = torch.clamp(row, max=A - 1)
    lmk = torch.where(hit[:, None], gm.pos[safe], torch.zeros_like(gm.pos[safe]))
    return lmk, hit, torch.where(hit, gm.src[safe], -1)
