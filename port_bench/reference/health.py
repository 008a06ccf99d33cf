"""The lane-health word of the tenant megabatch, over one lane, in numpy:
a frozen copy of the port's `tenancy/megabatch.py::lane_health_host`."""

from __future__ import annotations

import numpy as np
import torch

HEALTH_NONFINITE = 1    # NaN / Inf in the lane's poses or grid delta
HEALTH_POSE_JUMP = 2    # a within-tick estimate moved > pose_jump_max_m
HEALTH_MATCH_FLOOR = 4  # an accepted key match's response < match_floor


def lane_health(cfg, old_state, new_state, diag=None) -> int:
    """The word of one lane's tick from its state before and after."""
    def n(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    t = cfg.tenancy
    if not (t.enabled and t.lane_health):
        return 0
    word = 0
    new_p = n(new_state.est_poses)
    old_p = n(old_state.est_poses)
    gd = n(new_state.grid) - n(old_state.grid)
    if not (np.isfinite(new_p).all() and np.isfinite(gd).all()):
        word |= HEALTH_NONFINITE
    dxy = (new_p - old_p)[..., :2]
    jump = np.sqrt((dxy * dxy).sum(axis=-1)).max()
    if jump > t.pose_jump_max_m:
        word |= HEALTH_POSE_JUMP
    if t.match_floor > 0.0 and diag is not None:
        low = (n(diag.match_response) < t.match_floor) & n(diag.is_key)
        if low.any():
            word |= HEALTH_MATCH_FLOOR
    return word
