"""Transforms of collated (batched, numpy) samples (reference:
rmvd/data/batch_transforms.py:43-120), the JAX package's
``data/batch_transforms.py``.

The stateful ``Scale3DEqualizedBatch`` keeps a running 100-bin log histogram
of depths and rescales each batch's scene (pose translations, depth,
inverse depth, depth range) toward the least populated bin by matching
medians. Numpy on the host, before the batch is uploaded; random draws from
the global ``np.random`` in the JAX package's order.
"""

from __future__ import annotations

import numpy as np


def batched_depth_range(depth, default_min=0.1, default_max=100.0):
    """Per-sample (min, max) over valid pixels; (N, 2) float32

    (reference: rmvd/utils/torchutils.py:108-145)."""
    N = depth.shape[0]
    out = np.zeros((N, 2), np.float32)
    for i in range(N):
        d = depth[i]
        valid = d > 0
        if valid.any():
            out[i] = (d[valid].min(), d[valid].max())
        else:
            out[i] = (default_min, default_max)
    return out[:, 0], out[:, 1]


class Histogram:
    """Running histogram with optionally log-spaced bins plus +-inf edges

    (reference: batch_transforms.py:13-41)."""

    def __init__(self, range, num_bins, logarithmic_bin_sizes=False, exclude_inf=False):
        self.exclude_inf = exclude_inf
        if not logarithmic_bin_sizes:
            self.bins = list(np.linspace(range[0], range[1], num_bins + 1))
        else:
            self.bins = list(np.logspace(np.log10(range[0]), np.log10(range[1]), num_bins + 1))
        if not exclude_inf:
            self.bins = [-np.inf] + self.bins + [np.inf]
        self.counts = np.zeros(len(self.bins) - 1, dtype=np.int64)

    def add_values(self, values, mask=None):
        values = np.asarray(values)
        if mask is not None:
            values = values[np.asarray(mask).astype(bool)]
        self.counts += np.histogram(values, bins=self.bins)[0]

    @property
    def bin_ranges(self):
        return [(self.bins[i], self.bins[i + 1]) for i in range(len(self.bins) - 1)]


class Scale3DEqualizedBatch:
    def __init__(self, p, min_depth, max_depth):
        self._p = p
        self._counter = 0
        self.depth_histogram = Histogram(
            range=(min_depth, max_depth), num_bins=100, logarithmic_bin_sizes=True
        )

    def __call__(self, sample):
        poses = sample["poses"]  # list of (N, 4, 4)
        depth = sample["depth"]  # (N, 1, H, W)
        invdepth = sample["invdepth"]
        depth_mask = depth > 0

        if np.random.rand() < self._p and self._counter > 10:
            bin_idx = self.depth_histogram.counts[1:-1].argmin()
            # NOTE: indexes bin_ranges without re-adding the inf-bin offset,
            # faithfully reproducing the reference (batch_transforms.py:58-59);
            # the isfinite fallbacks below absorb the -inf edge case.
            bin_min, bin_max = self.depth_histogram.bin_ranges[bin_idx]
            if not np.isfinite(bin_min):
                bin_val = bin_max
            elif not np.isfinite(bin_max):
                bin_val = bin_min
            else:
                bin_val = np.random.uniform(bin_min, bin_max)

            N = depth.shape[0]
            scale_factors = np.ones(N, np.float32)
            for i in range(N):
                masked = depth[i][depth_mask[i]]
                if masked.size > 0:
                    sf = bin_val / np.median(masked)
                    scale_factors[i] = np.nan_to_num(sf, nan=1.0, posinf=1.0, neginf=1.0)

            sf_col = scale_factors[:, None]  # (N, 1)
            for idx, pose in enumerate(poses):
                pose = pose.copy()
                pose[:, :3, 3] = pose[:, :3, 3] * sf_col
                poses[idx] = pose
            depth = depth * scale_factors[:, None, None, None]
            invdepth = invdepth / scale_factors[:, None, None, None]

            sample["poses"] = poses
            sample["depth"] = depth
            sample["invdepth"] = invdepth
            sample["depth_range"] = batched_depth_range(depth)

        self._counter += 1
        self.depth_histogram.add_values(depth, depth_mask)
        return sample


class MaskDepthByMinMax:
    """(reference: batch_transforms.py:103-120)"""

    def __init__(self, min_depth, max_depth):
        self._min = min_depth
        self._max = max_depth

    def __call__(self, sample):
        depth = sample["depth"]
        invdepth = sample["invdepth"]
        mask = ((depth >= self._min) & (depth <= self._max)).astype(np.float32)
        sample["depth"] = depth * mask
        sample["invdepth"] = invdepth * mask
        sample["depth_range"] = batched_depth_range(sample["depth"])
        return sample
