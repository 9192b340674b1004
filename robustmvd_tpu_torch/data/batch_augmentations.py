"""Batch augmentation presets (reference: rmvd/data/batch_augmentations.py),
the JAX package's ``data/batch_augmentations.py``: the training engine takes
them by name (``batch_augmentations=``)."""

from .batch_transforms import MaskDepthByMinMax, Scale3DEqualizedBatch
from .registry import register_batch_augmentation
from .transforms import Compose


@register_batch_augmentation
def robust_mvd_batch_augmentations(**kwargs):
    return Compose(
        [
            Scale3DEqualizedBatch(p=1, min_depth=1 / 2.75, max_depth=1 / 0.009),
            MaskDepthByMinMax(min_depth=1 / 2.75, max_depth=1 / 0.009),
        ]
    )
