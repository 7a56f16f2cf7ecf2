"""Precomputed keypoints: one CSV of keypoints and descriptors per image.

Port of ``sadvio_tpu/frontend/csv_keypoints.py``.  The host parses
"<folder>/<ts>.csv" (a header row, then rows "[u, v], [d0, ..., dD-1]")
into fixed-capacity slots on the caller's device; matching is a masked L2
distance matrix with Lowe's ratio test and mutual best.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from sadvio_tpu_torch.utils.struct import entry_device


def load_csv_keypoints(folder: str, ts: int, *, capacity: int = 512, desc_dim: int = 128,
                       device=None):
    """"<folder>/<ts>.csv" -> uv (capacity,2), desc (capacity,D), valid
    (capacity,) on ``device`` (None: the CUDA card).  A missing file gives
    all-invalid slots; rows with fewer than 2 + D numbers are skipped."""
    device = entry_device(device)
    uv = np.zeros((capacity, 2), np.float32)
    desc = np.zeros((capacity, desc_dim), np.float32)
    valid = np.zeros((capacity,), bool)
    path = os.path.join(folder, f"{int(ts)}.csv")
    if os.path.exists(path):
        with open(path) as f:
            rows = f.read().strip().splitlines()[1:]
        n = 0
        for line in rows:
            if n >= capacity:
                break
            vals = line.replace("[", " ").replace("]", " ").replace(",", " ").split()
            if len(vals) < 2 + desc_dim:
                continue
            uv[n] = [float(vals[0]), float(vals[1])]
            desc[n] = [float(x) for x in vals[2:2 + desc_dim]]
            valid[n] = True
            n += 1
    t = lambda a: torch.as_tensor(a, device=device)
    return t(uv), t(desc), t(valid)


def match_csv_keypoints(desc_a, valid_a, desc_b, valid_b, uv_a=None, uv_b=None, *,
                        ratio: float = 0.9, max_dist: float = math.inf,
                        search_px: float = math.inf):
    """Masked L2 matching with Lowe's ratio and mutual best (and an optional
    search box).  Returns idx_b (Na,), ok (Na,)."""
    d2 = ((desc_a ** 2).sum(-1)[:, None] + (desc_b ** 2).sum(-1)[None, :]
          - 2.0 * desc_a @ desc_b.T)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    ok = valid_a[:, None] & valid_b[None, :] & (d < max_dist)
    if uv_a is not None and uv_b is not None and math.isfinite(float(search_px)):
        box = torch.abs(uv_a[:, None, :] - uv_b[None, :, :]).amax(-1)
        ok = ok & (box < search_px)
    inf = torch.full_like(d, math.inf)
    d = torch.where(ok, d, inf)
    best = torch.argmin(d, 1)
    dmin = d.amin(1)
    is_best = torch.arange(d.shape[1], device=d.device)[None, :] == best[:, None]
    d2nd = torch.where(is_best, inf, d).amin(1)
    back = torch.argmin(d, 0)
    mutual = back[best] == torch.arange(d.shape[0], device=d.device)
    return best, torch.isfinite(dmin) & (dmin < ratio * d2nd) & mutual
