"""Default viewer layouts (reference: rmvd/data/layouts.py:9-262).

Load functions return ``{"data": ndarray, "kind": str}``, as in the JAX
package; they are module-level functions or partials of them, so layouts
pickle with the standard library.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from .layout import Layout, Visualization


def _image(sample_dict, idx):
    img = sample_dict["images"][idx]
    return {"data": np.clip(img.transpose(1, 2, 0), 0, 255).astype(np.uint8), "kind": "image"}


def _float_map(arr):
    return {"data": arr.transpose(1, 2, 0) if arr.ndim == 3 else arr, "kind": "float"}


def _key_image(sample_dict, offset=0):
    return _image(sample_dict, sample_dict["keyview_idx"] + offset)


def _map(key, sample_dict):
    return _float_map(sample_dict[key])


def _gt_mask(sample_dict):
    return _float_map((sample_dict["depth"] > 0).astype(np.float32))


def _gt_visualizations(layout, col, key_col, key_row=0):
    """Key image, GT depth, GT inverse depth and GT mask, from column ``col``."""
    layout.visualizations += [
        Visualization(key_col, key_row, "image", _key_image, "Key Image"),
        Visualization(col, 1, "float", partial(_map, "depth"), "GT Depth"),
        Visualization(col + 1, 1, "float", partial(_map, "invdepth"), "GT Inverse Depth"),
        Visualization(col + 2, 1, "mask", _gt_mask, "GT Mask"),
    ]


class MVDSequentialDefaultLayout(Layout):
    """Key image + GT maps + up to 2 source views fore and aft

    (reference: layouts.py:9-105)."""

    def __init__(self, name, num_views, keyview_idx):
        self.num_views = num_views
        self.keyview_idx = keyview_idx
        super().__init__(name=name)
        _gt_visualizations(self, col=2, key_col=2)
        max_fwd = min(2, num_views - keyview_idx - 1)
        max_bwd = min(2, keyview_idx)
        for i in list(range(-max_bwd, 0)) + list(range(1, 1 + max_fwd)):
            self.visualizations.append(Visualization(
                2 + i, 0, "image", partial(_key_image, offset=i), f"Source Image @{'+' if i > 0 else ''}{i}"))


class MVDUnstructuredDefaultLayout(Layout):
    """Key image + GT maps + the first ``max_views`` source views in a grid

    (reference: layouts.py:107-210)."""

    def __init__(self, name, num_views, max_views):
        self.num_views = num_views
        self.max_views = max_views
        self.keyview_idx = 0
        super().__init__(name=name)
        _gt_visualizations(self, col=0, key_col=0)
        per_row = 5
        col, row = 1, 0
        for i in range(1, min(num_views, max_views)):
            self.visualizations.append(Visualization(
                col, row + 2 * (col // per_row), "image", partial(_image, idx=i), f"Source Image {i}"))
            col += 1


class EvalMVDLayout(Layout):
    """Evaluation qualitatives: key image + GT maps + the prediction maps the

    evaluation writes back as dataset updates (reference:
    multi_view_depth_evaluation.py:732-863 ``_get_layout``)."""

    def __init__(self, name="eval_mvd", eval_uncertainty=True):
        super().__init__(name=name)
        _gt_visualizations(self, col=0, key_col=0)
        self.visualizations += [
            Visualization(0, 2, "float", partial(_map, "pred_depth"), "Predicted Depth"),
            Visualization(1, 2, "float", partial(_map, "pred_invdepth"), "Predicted Inverse Depth"),
            Visualization(2, 2, "float", partial(_map, "pointwise_absrel"), "Absolute Relative Error"),
        ]
        if eval_uncertainty:
            self.visualizations.append(Visualization(
                3, 2, "float", partial(_map, "pred_depth_uncertainty"), "Predicted Depth Uncertainty"))


class AllImagesLayout(Layout):
    """All views in a grid (reference: layouts.py:213-262)."""

    def __init__(self, name, num_views):
        self.num_views = num_views
        super().__init__(name=name)
        per_row = 5
        for i in range(num_views):
            self.visualizations.append(Visualization(
                i % per_row, i // per_row, "image", partial(_image, idx=i), f"Image {i}"))
