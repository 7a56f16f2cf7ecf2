"""The comparison that decides ``correct``.

The timed path is followed stage by stage: for each compared stage, the
calls kept from the window (``hooks.Hooks``) are run again by the plain
reference (``portbench/reference``) on the same inputs, which are the
program's state at that call, converted into the reference's own types; the
program's outputs are then held to the reference's.  Each stage gives one
number, the largest over its kept calls of the gap below, and each number has
a limit of its own (``limits/<configuration>.json``).

Gap of a stage output: over its compared fields, the largest absolute
difference divided by the largest absolute value of the reference's field
(``rel``), on the rows that both sides hold valid.  The stage-by-stage check
starts from the program's state; the state itself, built over warm-up and
the window by stages that are not compared (the pyramids, the predictions,
VIInit, the keyframe vote), is checked by the window's trajectory against the
world's ground truth (``ate_m``: the worst 10 s segment, each aligned on its
own, as the repo's accuracy gates judge runs of that length).

The control is computed with TF32 matrix products and convolutions: the
nearest precision below the float32 with TF32 off that the program states.
For the stage gaps it is the reference in TF32 against the reference in
float32 (``control_numbers``); for the trajectory it is the whole program
run with TF32 on (``run.py --control 1``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.reference import build, stages as ref_stages
from portbench.reference.data import window as ref_window
from portbench.reference.models import cameras as ref_cameras, imu as ref_imu

REF_TYPES = {cls.__name__: cls for cls in (
    ref_window.WindowState, ref_window.Observations, ref_window.ImuChain, ref_window.PriorSet,
    ref_window.Rig, ref_imu.Preintegration, ref_cameras.Pinhole, ref_stages.TrackState)}

# the calls kept per stage, and the number each gives
KEEP = {"_preint": 8, "_frontend": 8, "_insert_kf": 4, "_backend": 4, "_marg_roll": 3}
NUMBERS = {"_preint": "preint_gap", "_frontend": "pose_gap", "_insert_kf": "insert_kf_gap",
           "_backend": "ba_gap", "_marg_roll": "prior_gap"}


def to_ref(x, device):
    """The nest ``x`` of the program's containers, rebuilt with the
    reference's types of the same names; tensors copied to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device).clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_ref(v, device) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(to_ref(v, device) for v in x)
    if isinstance(x, dict):
        return {k: to_ref(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = REF_TYPES[type(x).__name__]
        return cls(**{f.name: to_ref(getattr(x, f.name), device)
                      for f in dataclasses.fields(x)})
    return x


def rel(a, b, mask=None):
    """max |a - b| / max |b| over the rows of ``mask`` (all rows if None)."""
    a, b = a.double(), b.double()
    if mask is not None:
        a, b = a[mask], b[mask]
    if b.numel() == 0:
        return 0.0
    scale = b.abs().max().item()
    gap = (a - b).abs().max().item()
    return gap / scale if scale > 0 else gap


def gap_preint(out, ref):
    return max(rel(out.dR, ref.dR), rel(out.dv, ref.dv), rel(out.dp, ref.dp))


def gap_frontend(out, ref):
    """The frame's pose (R_new, t_new)."""
    return max(rel(out[1], ref[1]), rel(out[2], ref[2]))


def gap_insert_kf(out, ref):
    """The window's landmarks held by both sides after the insertion."""
    both = out[1].lmk_mask & ref[1].lmk_mask
    return rel(out[1].lmk, ref[1].lmk, both)


def _window_gap(w, r):
    kf = w.kf_mask & r.kf_mask
    lm = w.lmk_mask & r.lmk_mask
    return max(rel(w.R, r.R, kf), rel(w.t, r.t, kf), rel(w.v, r.v, kf), rel(w.ba, r.ba, kf),
               rel(w.bg, r.bg, kf), rel(w.lmk, r.lmk, lm))


def gap_backend(out, ref):
    """The window after the BA and its outlier gate."""
    return _window_gap(out[0], ref[0])


def gap_marg_roll(out, ref):
    """The prior after marginalization and sparsification: its pose and
    landmark priors and their square-root information."""
    p, q = out[3], ref[3]
    sp = p.sp_mask & q.sp_mask
    lp = p.lp_mask & q.lp_mask
    return max(rel(p.sp_sqrt_info, q.sp_sqrt_info, sp), rel(p.sp_t, q.sp_t, sp),
               rel(p.sp_R, q.sp_R, sp), rel(p.lp_sqrt_info, q.lp_sqrt_info, lp),
               rel(p.lp_val, q.lp_val, lp), rel(p.dn_J, q.dn_J) if bool(p.dn_mask & q.dn_mask)
               else 0.0)


GAPS = {"_preint": gap_preint, "_frontend": gap_frontend, "_insert_kf": gap_insert_kf,
        "_backend": gap_backend, "_marg_roll": gap_marg_roll}


@contextlib.contextmanager
def _precision(tf32: bool, device):
    """TF32 on or off for matrix products and convolutions; cuSOLVER for
    ``torch.linalg`` on the card, as the program's stages have it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    lib = None
    if torch.device(device).type == "cuda":
        lib = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        if lib is not None:
            torch.backends.cuda.preferred_linalg_library(lib)


def reference_outputs(cfg: dict, samples: dict, device, tf32=False) -> dict:
    """{stage: [reference output per kept call]}."""
    rig = build.rig(cfg, device)
    rcfg = build.config(cfg)
    cls = ref_stages.MonoStages if rcfg.slam_mode in ("mono", "monovio") else ref_stages.Stages
    st = cls(rig, rcfg, build.imu_params(cfg))
    out = {}
    with _precision(tf32, device), torch.no_grad():
        for name, calls in samples.items():
            fn = getattr(st, name)
            out[name] = []
            for _, inputs, _ in calls:
                args, kwargs = to_ref(inputs, device)
                out[name].append(fn(*args, **kwargs))
    return out


def numbers(samples: dict, refs: dict) -> dict:
    """{number: largest gap over the kept calls} between the kept outputs
    and ``refs``; a stage with no kept call gives no number."""
    return {NUMBERS[name]: max(GAPS[name](out, r) for (_, _, out), r in zip(calls, refs[name]))
            for name, calls in samples.items() if calls}


def control_numbers(refs: dict, controls: dict) -> dict:
    """The numbers the control would give in the program's place."""
    return {NUMBERS[name]: max(GAPS[name](c, r) for c, r in zip(controls[name], refs[name]))
            for name in refs if refs[name]}


ATE_SEGMENT_S = 10.0  # the trajectory is aligned and judged in segments of this length


def ate(t_est, gt_t, with_scale: bool) -> float:
    """RMS position error of the frames' estimates after a Umeyama alignment
    to the ground truth: SE(3), or Sim(3) ``with_scale`` (monocular runs)."""
    e, g = np.asarray(t_est, np.float64), np.asarray(gt_t, np.float64)
    E, G = e - e.mean(0), g - g.mean(0)
    U, S, Vt = np.linalg.svd(E.T @ G)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ D @ Vt).T
    s = (S * np.diag(D)).sum() / max((E ** 2).sum(), 1e-12) if with_scale else 1.0
    return float(np.sqrt(((s * E @ R.T - G) ** 2).sum(-1).mean()))


def worst_segment_ate(t_done, t_est, gt_t, with_scale: bool) -> float:
    """The largest ``ate`` over consecutive ``ATE_SEGMENT_S`` segments of the
    window (frames grouped by when their pose came; ``t_done`` seconds since
    the window opened; a last segment of fewer than 3 frames joins the one
    before).  A frame with no finite pose (``None``), or fewer than 3 frames
    in all, fails the run."""
    if len(t_est) < 3 or any(t is None for t in t_est):
        return float("inf")
    seg = (np.asarray(t_done) // ATE_SEGMENT_S).astype(int)
    if (seg == seg[-1]).sum() < 3:
        seg[seg == seg[-1]] = max(seg[-1] - 1, 0)
    est, gt = np.asarray(t_est), np.asarray(gt_t)
    return max(ate(est[seg == k], gt[seg == k], with_scale) for k in np.unique(seg))
