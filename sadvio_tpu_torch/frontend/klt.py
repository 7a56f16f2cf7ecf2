"""Pyramidal inverse-compositional Lucas-Kanade tracking, batched.

Port of ``sadvio_tpu/frontend/klt.py``.  ``track`` has two engines, both in
``ops.klt_kernel``: "fused" is one ``lk_track`` launch for the whole track
(templates, every level's loop, backward pass and gates inside the CUDA
kernel; its plain version on the CPU), "levels" builds the templates with
tensor ops and launches ``lk_iterate`` once per level.  The JAX package's
TPU workarounds are gone: pyramid levels are not padded (the kernels clamp
taps to the image edge, which gives the values edge padding gave), and
windows and patches are read with plain indexing instead of one-hot matrix
contractions.
"""

from __future__ import annotations

from sadvio_tpu_torch.ops import klt_kernel
from sadvio_tpu_torch.ops.klt_kernel import (  # noqa: F401  (part of this module's interface)
    pyramid_dims, template_windows, templates as _templates,
)


def build_pyramid(img, levels: int = 3):
    """List of images, level 0 = full res; 2x2 average-pool downsampling."""
    pyr = [img]
    for _ in range(levels - 1):
        x = pyr[-1]
        H, W = x.shape
        x = x[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2).mean((1, 3))
        pyr.append(x)
    return pyr


def template_windows_pyr(pyr, uv0, levels: int, radius: int):
    """Per-level cached template windows for track(tmpl_wins=...)."""
    return tuple(template_windows(pyr[lvl], uv0 / (2.0 ** lvl), radius)
                 for lvl in range(levels))


def track(pyr0, pyr1, uv0, uv_init, valid0, *, levels: int = 3, radius: int = 7,
          iters: int = 10, iters_coarse: int = 6, min_eig: float = 1e-3,
          fb_thresh: float = 0.5, max_err: float = 20.0, warp=None, engine: str = "fused",
          bwd_levels: int = 1, tmpl_wins=None, eps: float = 0.01):
    """Track uv0 from pyramid pyr0 to pyr1 starting at uv_init.

    Forward pass over all levels, backward pass on ``bwd_levels`` levels
    from the answer, forward-backward gate at ``fb_thresh`` px.  ``warp``
    (N,2,2), optional: per-feature affine template warp (identity where it
    is singular or not finite).  ``engine``: "fused" (one ``lk_track``
    launch; reads ``pyr0`` itself, so ``tmpl_wins`` is not used) or
    "levels" (tensor-op templates, one ``lk_iterate`` launch per level).
    Returns (uv1, valid, err)."""
    kw = dict(levels=levels, radius=radius, iters=iters, iters_coarse=iters_coarse,
              min_eig=min_eig, fb_thresh=fb_thresh, max_err=max_err, bwd_levels=bwd_levels,
              eps=eps)
    if engine == "fused":
        return klt_kernel.lk_track(
            pyr0, pyr1, uv0.contiguous(), uv_init.contiguous(), valid0.contiguous(),
            None if warp is None else warp.contiguous(), **kw)
    if engine == "levels":
        return klt_kernel.track_levels(pyr0, pyr1, uv0, uv_init, valid0, warp,
                                       tmpl_wins=tmpl_wins, **kw)
    raise ValueError(f"track: unknown engine {engine!r}")
