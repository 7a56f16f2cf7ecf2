"""The least time the card could take for a kernel's work, from the shapes
and counts of its inputs: a frozen copy of the bytes side of
``chip_smoke.py``'s arithmetic (``bound_lk_track``), against the H100 SXM
data sheet's memory rate.

The operations side is left out: ``lk_track`` stops each feature's
iterations at a step below ``eps``, and how many it ran is not read back,
so a count at the iteration cap would overstate the work.  The bound is the
bytes the launch has to move, and the share of it is a lower bound of the
kernel's share of its roofline."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet: device memory rate


def pyramid_dims(shape0, levels: int):
    dims = [tuple(shape0)]
    for _ in range(levels - 1):
        h, w = dims[-1]
        dims.append(((h - h % 2) // 2, (w - w % 2) // 2))
    return dims


def lk_track_s(live: int, n_slots: int, shape0, levels: int, radius: int,
               warp: bool = True) -> float:
    """Seconds one ``lk_track`` launch needs at least to move its bytes.
    Its answer is read only where ``valid0`` holds, so of the images it must
    read, for each of the ``live`` slots at each level, the (S+2)^2 halo its
    template is built from and the (S+1)^2 pixels a bilinear S x S sample
    touches in the other pyramid, never more than the two float32 pyramids
    hold; every per-slot input is read once and (uv, valid, err) written
    once."""
    S = 2 * radius + 1
    images = 2 * sum(h * w * 4 for h, w in pyramid_dims(shape0, levels))
    windows = min(live * levels * ((S + 2) ** 2 + (S + 1) ** 2) * 4, images)
    slots = n_slots * (2 * 8 + 1 + (16 if warp else 0))
    out = n_slots * (2 * 4 + 1 + 4)
    return (windows + slots + out) / PEAK_BYTES_S
