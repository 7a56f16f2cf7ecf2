"""Pyramidal inverse-compositional Lucas-Kanade tracking, batched.

Frozen copy of the port's ``frontend/klt.py``, fused engine only, which runs the plain
version of the track (``ops.klt_kernel.lk_track_ref``): the reference never
launches the port's CUDA kernels.  The JAX package's
TPU workarounds are gone: pyramid levels are not padded (the kernels clamp
taps to the image edge, which gives the values edge padding gave), and
windows and patches are read with plain indexing instead of one-hot matrix
contractions.
"""

from __future__ import annotations

from portbench.reference.ops import klt_kernel


def build_pyramid(img, levels: int = 3):
    """List of images, level 0 = full res; 2x2 average-pool downsampling."""
    pyr = [img]
    for _ in range(levels - 1):
        x = pyr[-1]
        H, W = x.shape
        x = x[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2).mean((1, 3))
        pyr.append(x)
    return pyr


def track(pyr0, pyr1, uv0, uv_init, valid0, *, levels: int = 3, radius: int = 7,
          iters: int = 10, iters_coarse: int = 6, min_eig: float = 1e-3,
          fb_thresh: float = 0.5, max_err: float = 20.0, warp=None, engine: str = "fused",
          bwd_levels: int = 1, tmpl_wins=None, eps: float = 0.01):
    """Track uv0 from pyramid pyr0 to pyr1 starting at uv_init.

    Forward pass over all levels, backward pass on ``bwd_levels`` levels
    from the answer, forward-backward gate at ``fb_thresh`` px.  ``warp``
    (N,2,2), optional: per-feature affine template warp (identity where it
    is singular or not finite).  ``engine``: "fused" only, the plain
    version of the one ``lk_track`` launch, which reads ``pyr0`` itself, so
    ``tmpl_wins`` is not used.  Returns (uv1, valid, err)."""
    kw = dict(levels=levels, radius=radius, iters=iters, iters_coarse=iters_coarse,
              min_eig=min_eig, fb_thresh=fb_thresh, max_err=max_err, bwd_levels=bwd_levels,
              eps=eps)
    if engine != "fused":
        raise ValueError(f"track: the reference copies the fused engine only, not {engine!r}")
    return klt_kernel.lk_track_ref(
        pyr0, pyr1, uv0.contiguous(), uv_init.contiguous(), valid0.contiguous(),
        None if warp is None else warp.contiguous(), **kw)
