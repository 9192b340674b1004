"""The port's ``utils/vis.py`` vs the JAX package's on the same seeded arrays.

Every rendering is compared as uint8 pixels, bit-equal (both are numpy and
PIL with one turbo table; nothing differs in float order): ``vis``'s
dispatch over 2D arrays, (3, H, W) images and their batches, with
``full_batch`` (False, True, "cols", "rows") and ``batch_labels``; clipping
(automatic and given thresholds, marked or not), invalid values; the gray
colormap; ``colormap_2d`` with and without a clip range; ``add_text_to_img``
from the top and the bottom; ``cat_images_colwise`` / ``rowwise`` of unequal
sizes; ``invalidate_np_array``'s masks and thresholds; ``check_vis``. The
port takes torch tensors where JAX takes numpy arrays.
"""

import importlib

import numpy as np
import pytest
import torch
from PIL import Image

# the modules (the JAX package's ``utils`` also exports a function named vis)
jax_vis = importlib.import_module("robustmvd_tpu.utils.vis")
vis = importlib.import_module("robustmvd_tpu_torch.utils.vis")


def depth_like(rng, *shape):
    arr = (rng.rand(*shape) * 9 + 1).astype(np.float32)
    arr.reshape(-1)[::11] = np.nan
    arr.reshape(-1)[::17] = 0.0
    arr.reshape(-1)[::23] = 40.0
    return arr


def pixels(img):
    return np.asarray(img) if isinstance(img, np.ndarray) else np.array(img)


CASES = {
    "2d": ((24, 32), {}),
    "2d_1hw": ((1, 24, 32), {}),
    "2d_11hw": ((1, 1, 24, 32), {}),
    "2d_batch_cols": ((3, 24, 32), {"full_batch": True, "batch_labels": ["a", "b", "c"]}),
    "2d_batch_rows": ((3, 1, 24, 32), {"full_batch": "rows"}),
    "2d_clipping_auto_marked": ((24, 32), {"clipping": True, "mark_clipping": True, "mark_invalid": True}),
    "2d_clipping_given": ((24, 32), {"clipping": True, "upper_clipping_thresh": 6.0, "lower_clipping_thresh": 2.0,
                                     "invalid_values": [0.0], "text": "depth", "label": "gt"}),
    "2d_gray": ((24, 32), {"colorize": False, "mark_invalid": True, "image_range_colors_off": True}),
    "2d_text_off": ((24, 32), {"text_off": True, "image_range_text_off": True, "out_format": {"type": "np"}}),
    "image": ((3, 24, 32), {}),
    "image_batch_cols": ((2, 3, 24, 32), {"full_batch": "cols", "batch_labels": ["k", "s"]}),
    "image_clipping": ((3, 24, 32), {"clipping": True, "mark_clipping": True, "mark_invalid": True}),
}


@pytest.mark.parametrize("case", CASES)
def test_vis_renders_as_jax(case):
    shape, kwargs = CASES[case]
    arr = depth_like(np.random.RandomState(len(case)), *shape)
    ours = vis.vis(torch.from_numpy(arr), **kwargs)
    ref = jax_vis.vis(arr, **kwargs)
    assert type(ours) is type(ref)
    assert pixels(ours).dtype == np.uint8 and np.array_equal(pixels(ours), pixels(ref))


@pytest.mark.parametrize("clip_range", [None, (2.0, 8.0)])
def test_colormap_2d_as_jax(clip_range):
    arr = depth_like(np.random.RandomState(7), 1, 24, 32)
    ours = vis.colormap_2d(torch.from_numpy(arr), clip_range=clip_range)
    assert ours.dtype == np.uint8 and np.array_equal(ours, jax_vis.colormap_2d(arr, clip_range=clip_range))
    assert np.array_equal(vis.colormap_2d(arr, mark_invalid=False), jax_vis.colormap_2d(arr, mark_invalid=False))


def test_text_and_concatenation_as_jax():
    def canvas(h, w, c):
        return Image.fromarray(np.full((h, w, 3), c, np.uint8))

    def render(module):
        return [module.add_text_to_img(canvas(40, 60, 20), [("top", "yellow"), "next"], xy_lefttop=(2, 3)),
                module.add_text_to_img(canvas(40, 60, 20), "bottom", xy_leftbottom=(4, 4)),
                module.cat_images_colwise([canvas(10, 12, 1), canvas(14, 8, 2)]),
                module.cat_images_rowwise([canvas(10, 12, 1), canvas(14, 8, 2)])]

    for ours, ref in zip(render(vis), render(jax_vis)):
        assert np.array_equal(np.array(ours), np.array(ref))


@pytest.mark.parametrize("clipping", [False, True])
def test_invalidate_np_array_as_jax(clipping):
    arr = depth_like(np.random.RandomState(3), 16, 20)
    ours = vis.invalidate_np_array(arr, clipping=clipping, invalid_values=[0.0])
    ref = jax_vis.invalidate_np_array(arr, clipping=clipping, invalid_values=[0.0])
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)


def test_check_vis_as_jax():
    for shape in ((4, 5), (2, 4, 5), (2, 1, 4, 5), (2, 3, 4, 5), (2, 2, 4, 5), (1, 2, 3, 4, 5)):
        assert vis.check_vis(torch.zeros(shape)) == jax_vis.check_vis(np.zeros(shape)), shape
