"""Scale/shift-invariant losses and masked segment statistics (counterpart
of iris_tpu/utils/losses.py; reference utils/loss.py compute_scale :14,
compute_scale_shift :22, scale_invariant_mse :33,
scale_shift_invariant_mse :39). The segment means replace the reference's
torch_scatter patterns with a deterministic segment sum over a fixed
segment count (core/segment.py)."""

from __future__ import annotations

import torch

from iris_tpu_torch.core.segment import segment_sum


def compute_scale(source: torch.Tensor, target: torch.Tensor
                  ) -> torch.Tensor:
    """Least-squares scalar s minimizing ||s*source - target||^2."""
    s, t = source.reshape(-1), target.reshape(-1)
    return torch.dot(s, t) / torch.clamp(torch.dot(s, s), min=1e-12)


def compute_scale_shift(source: torch.Tensor, target: torch.Tensor):
    """Least-squares (scale, shift): target ~ scale*source + shift."""
    s, t = source.reshape(-1), target.reshape(-1)
    n = s.shape[0]
    sx = torch.sum(s)
    sxx = torch.dot(s, s)
    sxt = torch.dot(s, t)
    st = torch.sum(t)
    det = sxx * n - sx * sx
    scale = (sxt * n - sx * st) / torch.clamp(det, min=1e-12)
    shift = (sxx * st - sx * sxt) / torch.clamp(det, min=1e-12)
    return scale, shift


def scale_invariant_mse(source, target):
    scale = compute_scale(source, target).detach()
    return torch.mean((source * scale - target) ** 2)


def scale_shift_invariant_mse(source, target):
    scale, shift = compute_scale_shift(source, target)
    return torch.mean((source * scale.detach() + shift.detach()
                       - target) ** 2)


def segment_mean(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int, weights: torch.Tensor | None = None):
    """Weighted per-segment mean, per segment AND gathered back to the
    elements. values (B, C) or (B,), seg_ids (B,) int64 in
    [0, num_segments) (reference train_brdf_crf.py:225-238)."""
    v = values if values.dim() > 1 else values[:, None]
    if weights is None:
        weights = torch.ones(v.shape[0], dtype=v.dtype, device=v.device)
    # the weighted values and the weights in one sum: each column is
    # added on its own, so the bits are those of two sums
    sums = segment_sum(torch.cat([v * weights[:, None], weights[:, None]],
                                 1), seg_ids, num_segments)
    mean = sums[:, :-1] / torch.clamp(sums[:, -1], min=1e-8)[:, None]
    per_elem = mean[seg_ids]
    if values.dim() == 1:
        return mean[:, 0], per_elem[:, 0]
    return mean, per_elem


def mse(a, b):
    return torch.mean((a - b) ** 2)
