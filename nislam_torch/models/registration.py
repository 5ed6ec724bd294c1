"""Standalone KCC registration model: pairwise and batched image alignment.

Counterpart of ``nislam_tpu.models.registration``: the bare registration
engine as a user-facing model.  Give it two images (or a batch of pairs)
and get back the relative (x, y, θ) in pixels and radians with PSR
confidences; no SLAM state is involved.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nislam_torch.ops.registration import compute_intermedium, compute_pose, make_cf_ops


class KCCRegistration:
    """Pairwise registration at the fixed image size of ``cfg`` (a
    ``CFConfig``) on ``device``, the card unless the caller asks for
    another."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.ops = make_cf_ops(cfg).to(self.device)

    def _register(self, ref, cur, large_rotation: bool):
        ref = torch.as_tensor(ref, dtype=torch.float32).to(self.device)
        cur = torch.as_tensor(cur, dtype=torch.float32).to(self.device)
        ref_fft, ref_polar = compute_intermedium(ref, self.ops)
        _, cur_polar = compute_intermedium(cur, self.ops)
        return compute_pose(ref_fft, cur, ref_polar, cur_polar, self.ops,
                            large_rotation=large_rotation)

    def register(self, reference, current, *, large_rotation: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Relative pose of ``current`` with respect to ``reference``, both
        (H, W) in [0, 1].

        Returns ``(pose, response)``: pose = (x_px, y_px, θ_rad) in the
        reference's sign conventions; response = (psr_t, psr_t, psr_rot).
        ``large_rotation=True`` resolves the 180° ambiguity of the power
        spectrum by testing both hypotheses (loop-closure mode)."""
        return self._register(reference, current, large_rotation)

    def register_batch(self, references, currents, *, large_rotation: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W) × (B, H, W) → ((B, 3), (B, 3)): B pairs through one
        batched FFT pipeline."""
        return self._register(references, currents, large_rotation)
