"""Batched descriptor matching with search-box gating.

Port of ``sadvio_tpu/frontend/match.py``.  Everything is one masked
distance matrix: Hamming distance between BRIEF descriptors, gated by a
search radius around a predicted position, then a Lowe ratio test and a
mutual-best check.  Descriptors are (N,256) bool tensors (the JAX package
packs them into 8 uint32 words and counts bits; PyTorch has no popcount, so
the distance is one float matrix product, exact for 0/1 entries).

Ties: integer Hamming distances tie often.  Every argmin/argmax here takes
the lowest index among equal values, as the JAX package does;
``torch.argmin`` alone does not promise that on CUDA.
"""

from __future__ import annotations

import torch

BIG = 1e9


def first_argmin(x, dim: int):
    """(index, value) of the minimum along dim; the lowest index on ties."""
    m = x.amin(dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    ar = torch.arange(n, device=x.device).reshape(shape)
    idx = torch.where(x == m, ar, n).amin(dim)
    return torch.clamp(idx, max=n - 1), m.squeeze(dim)


def hamming(desc_a, desc_b):
    """Pairwise Hamming distance of (Na,B) and (Nb,B) bool descriptors -> (Na,Nb) float."""
    a, b = desc_a.float(), desc_b.float()
    return a.sum(-1)[:, None] + b.sum(-1)[None, :] - 2.0 * (a @ b.T)


def _gate(uv_pred_a, valid_a, uv_b, valid_b, search_radius):
    dist2 = ((uv_pred_a[:, None] - uv_b[None, :]) ** 2).sum(-1)
    return (dist2 < search_radius * search_radius) & valid_a[:, None] & valid_b[None, :]


def match(desc_a, uv_pred_a, valid_a, desc_b, uv_b, valid_b,
          search_radius=60.0, ratio=0.9, max_dist=80.0):
    """Match set A (with predicted positions in B's image) against set B.

    Returns (idx (Na,) int64 index into B or -1, best distance (Na,))."""
    d = hamming(desc_a, desc_b)
    d = torch.where(_gate(uv_pred_a, valid_a, uv_b, valid_b, search_radius), d,
                    torch.full_like(d, BIG))
    rows = torch.arange(d.shape[0], device=d.device)
    best, best_d = first_argmin(d, 1)
    cols = torch.arange(d.shape[1], device=d.device)
    d2 = torch.where(cols[None, :] == best[:, None], BIG, d)
    ratio_ok = best_d < ratio * d2.amin(1)
    # mutual best: B's best row for the chosen column must be this row
    best_b, _ = first_argmin(d, 0)
    ok = ratio_ok & (best_b[best] == rows) & (best_d < max_dist) & valid_a
    return torch.where(ok, best, -1), best_d


def match_zncc(patches_a, valid_a, patches_b, valid_b, uv_pred_a, uv_b,
               search_radius=40.0, min_zncc=0.7):
    """Patch-correlation matching for when descriptors are unavailable.

    patches: (N,S) zero-mean normalized patch vectors.  Returns (idx or -1,
    best score)."""
    score = patches_a @ patches_b.T
    score = torch.where(_gate(uv_pred_a, valid_a, uv_b, valid_b, search_radius), score,
                        torch.full_like(score, -2.0))
    rows = torch.arange(score.shape[0], device=score.device)
    best, neg_s = first_argmin(-score, 1)
    best_b, _ = first_argmin(-score, 0)
    ok = (best_b[best] == rows) & (-neg_s > min_zncc) & valid_a
    return torch.where(ok, best, -1), -neg_s
