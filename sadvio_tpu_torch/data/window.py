"""Sliding-window state as fixed-shape masked tensors.

Port of ``sadvio_tpu/data/window.py`` (``LineBlock`` is not ported yet).
Identity is the slot index; lifecycle flags are bitmask tensors; the
window is the leading axis of every tensor.  Index tensors are int64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sadvio_tpu_torch.models.imu import Preintegration
from sadvio_tpu_torch.utils.struct import Struct

LMK_INITIALIZED = 1
LMK_IN_MAP = 2
LMK_OUTLIER = 4
LMK_MARGINALIZED = 8
LMK_RESURRECTED = 16
LMK_HAS_PRIOR = 32


def _eyes(n, dtype, device):
    return torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3).clone()


@dataclass
class WindowState(Struct):
    """Estimator state over the window; poses are world-from-body."""

    R: torch.Tensor  # (K,3,3)
    t: torch.Tensor  # (K,3)
    v: torch.Tensor  # (K,3)
    ba: torch.Tensor  # (K,3)
    bg: torch.Tensor  # (K,3)
    kf_mask: torch.Tensor  # (K,) bool
    ts: torch.Tensor  # (K,)
    lmk: torch.Tensor  # (L,3)
    lmk_mask: torch.Tensor  # (L,) bool
    lmk_flags: torch.Tensor  # (L,) int64 bitfield

    @classmethod
    def create(cls, K: int, L: int, dtype=torch.float32, device=None):
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return cls(
            R=_eyes(K, dtype, device), t=z(K, 3), v=z(K, 3), ba=z(K, 3), bg=z(K, 3),
            kf_mask=torch.zeros(K, dtype=torch.bool, device=device), ts=z(K),
            lmk=z(L, 3), lmk_mask=torch.zeros(L, dtype=torch.bool, device=device),
            lmk_flags=torch.zeros(L, dtype=torch.int64, device=device),
        )

    @property
    def K(self):
        return self.R.shape[0]

    @property
    def L(self):
        return self.lmk.shape[0]


@dataclass
class Observations(Struct):
    """Dense observation table: landmark l seen by camera c at keyframe k."""

    uv: torch.Tensor  # (K,C,L,2)
    mask: torch.Tensor  # (K,C,L) bool

    @classmethod
    def create(cls, K: int, C: int, L: int, dtype=torch.float32, device=None):
        return cls(uv=torch.zeros((K, C, L, 2), dtype=dtype, device=device),
                   mask=torch.zeros((K, C, L), dtype=torch.bool, device=device))


@dataclass
class Rig(Struct):
    """Multi-camera rig: camera model with (C,) parameters + extrinsics T_f_s."""

    cam: object
    R_f_s: torch.Tensor  # (C,3,3)
    t_f_s: torch.Tensor  # (C,3)

    @property
    def C(self):
        return self.t_f_s.shape[0]


@dataclass
class ImuChain(Struct):
    """Preintegrations between consecutive KF slots (k -> k+1), batched (K-1,)."""

    pre: Preintegration
    mask: torch.Tensor  # (K-1,) bool

    @classmethod
    def create(cls, K: int, dtype=torch.float32, device=None):
        return cls(pre=Preintegration.identity(dtype, device, batch=(K - 1,)),
                   mask=torch.zeros(K - 1, dtype=torch.bool, device=device))


@dataclass
class PriorSet(Struct):
    """Marginalization prior as a set of sparsified factors (see the JAX
    package's PriorSet for the meaning of each block)."""

    sp_R: torch.Tensor  # (K,3,3)
    sp_t: torch.Tensor  # (K,3)
    sp_v: torch.Tensor
    sp_ba: torch.Tensor
    sp_bg: torch.Tensor
    sp_sqrt_info: torch.Tensor  # (K,15,15)
    sp_mask: torch.Tensor  # (K,) bool
    prior_slots: torch.Tensor  # (P,) int64
    prior_slot_mask: torch.Tensor  # (P,) bool
    lp_val: torch.Tensor  # (P,3)
    lp_sqrt_info: torch.Tensor  # (P,3,3)
    lp_mask: torch.Tensor
    plp_val: torch.Tensor
    plp_frame: torch.Tensor  # (P,) int64
    plp_sqrt_info: torch.Tensor
    plp_mask: torch.Tensor
    ll_a: torch.Tensor  # (P,) int64
    ll_b: torch.Tensor
    ll_val: torch.Tensor
    ll_sqrt_info: torch.Tensor
    ll_mask: torch.Tensor
    dn_J: torch.Tensor  # (15+3P, 15+3P)
    dn_r: torch.Tensor
    dn_R: torch.Tensor
    dn_t: torch.Tensor
    dn_v: torch.Tensor
    dn_ba: torch.Tensor
    dn_bg: torch.Tensor
    dn_lmk: torch.Tensor
    dn_frame: torch.Tensor  # () int64
    dn_mask: torch.Tensor  # () bool

    @classmethod
    def create(cls, K: int, P: int, dtype=torch.float32, device=None):
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        zi = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
        Dd = 15 + 3 * P
        return cls(
            sp_R=_eyes(K, dtype, device), sp_t=z(K, 3), sp_v=z(K, 3),
            sp_ba=z(K, 3), sp_bg=z(K, 3), sp_sqrt_info=z(K, 15, 15), sp_mask=zb(K),
            prior_slots=zi(P), prior_slot_mask=zb(P),
            lp_val=z(P, 3), lp_sqrt_info=z(P, 3, 3), lp_mask=zb(P),
            plp_val=z(P, 3), plp_frame=zi(P), plp_sqrt_info=z(P, 3, 3), plp_mask=zb(P),
            ll_a=zi(P), ll_b=zi(P), ll_val=z(P, 3), ll_sqrt_info=z(P, 3, 3), ll_mask=zb(P),
            dn_J=z(Dd, Dd), dn_r=z(Dd),
            dn_R=torch.eye(3, dtype=dtype, device=device), dn_t=z(3), dn_v=z(3),
            dn_ba=z(3), dn_bg=z(3), dn_lmk=z(P, 3), dn_frame=zi(), dn_mask=zb(),
        )

    @property
    def P(self):
        return self.prior_slots.shape[0]
