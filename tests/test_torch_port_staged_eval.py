"""Device-staged images in the evaluation.

- ``utils/image.py::resize_bilinear_torch`` against the numpy resize (the
  port's and the JAX package's, without its native library) bit for bit,
  at sizes that need a resize and one that does not, among them KITTI's
  375x1242 -> 384x1280.
- robust_mvd's input adapter on staged tensors gives the network the numpy
  path's bits, with and without a resize.
- The engine uploads a sample's views once: every run of a sample gets the
  same tensor objects, and a model without ``supports_device_images`` gets
  numpy views.
- With bridged weights, the tables against the JAX engine's (JAX
  ``corr_impl="matmul"``) at a size that needs a resize, within PERF.md
  §2's limits.
"""

import numpy as np
import pytest
import torch

from robustmvd_tpu.models.robust_mvd import RobustMVD as JaxRobustMVD
from robustmvd_tpu.utils.image import resize_bilinear as jax_resize_bilinear
from robustmvd_tpu_torch import create_dataset, create_evaluation, create_model
from robustmvd_tpu_torch.utils.image import resize_bilinear, resize_bilinear_torch

from test_torch_port_eval import DuckModel, check_bridged_robust_mvd_engine


@pytest.fixture
def no_native_resize(monkeypatch):
    import robustmvd_tpu.utils.native as native

    monkeypatch.setattr(native, "resize_bilinear_native", lambda img, size: None)


@pytest.mark.parametrize("shape, size", [((1, 3, 375, 1242), (384, 1280)), ((2, 3, 120, 250), (128, 256)),
                                         ((3, 37, 53), (64, 64)), ((1, 3, 100, 90), (50, 45)),
                                         ((1, 3, 64, 128), (64, 128))])
def test_torch_resize_is_the_numpy_resize_bit_for_bit(no_native_resize, shape, size):
    img = (np.random.RandomState(0).rand(*shape) * 255).astype(np.float32)
    ours = resize_bilinear_torch(torch.from_numpy(img), size)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == shape[:-2] + size
    np.testing.assert_array_equal(ours.numpy(), resize_bilinear(img, size))
    np.testing.assert_array_equal(ours.numpy(), jax_resize_bilinear(img, size))


@pytest.mark.parametrize("size", [(60, 120), (64, 128)], ids=["resized", "not_resized"])
def test_staged_input_adapter_gives_the_numpy_bits(size):
    model = create_model("robust_mvd", device="cpu")
    assert model.supports_device_images and JaxRobustMVD.supports_device_images
    rng = np.random.RandomState(1)
    H, W = size
    images = [(rng.rand(1, 3, H, W) * 255).astype(np.float32) for _ in range(3)]
    K = np.array([[[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]]], np.float32)
    poses = [np.eye(4, dtype=np.float32)[None] for _ in range(3)]
    args = dict(keyview_idx=np.array([1]), poses=poses, intrinsics=[K] * 3)
    ref = model.input_adapter(images=images, **args)
    ours = model.input_adapter(images=[torch.from_numpy(img) for img in images], **args)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert torch.equal(ours[key], ref[key]), key
    assert tuple(ours["images"].shape) == (1, 3, 3, 64, 128)


class Spy:
    """Notes the image objects each run's input adapter receives."""

    def __init__(self, model):
        self.model, self.runs = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def input_adapter(self, images, **kwargs):
        self.runs.append((self.model_sample, list(images)))
        return self.model.input_adapter(images=images, **kwargs)

    def __call__(self, **kwargs):
        return self.model(**kwargs)


@pytest.mark.parametrize("staged", [True, False], ids=["robust_mvd", "duck_model"])
def test_engine_uploads_each_sample_once(staged):
    config = dict(num_samples=2, num_views=3, height=60, width=120)
    spy = Spy(create_model("robust_mvd", device="cpu") if staged else DuckModel())
    evaluation = create_evaluation("mvd", inputs=["poses", "intrinsics"], view_ordering="quasi-optimal",
                                   eval_uncertainty=False, verbose=False)
    run_model = evaluation._run_model

    def noted(sample_inputs):
        spy.model_sample = evaluation.cur_sample_num
        return run_model(sample_inputs)

    evaluation._run_model = noted
    evaluation(dataset=create_dataset("synthetic.train.mvd", **config), model=spy, qualitatives=0)
    assert len(spy.runs) == 2 * 4  # per sample: 2 ordering pairs, then 1..2 source views
    for sample in range(2):
        seen = [image for num, images in spy.runs if num == sample for image in images]
        if staged:
            assert all(isinstance(image, torch.Tensor) for image in seen)
            assert len({id(image) for image in seen}) == config["num_views"]
        else:
            assert all(isinstance(image, np.ndarray) for image in seen)


def test_staged_engine_with_bridged_robust_mvd_agrees_with_jax(tmp_path, no_native_resize):
    """robust_mvd at full width, 3 views at 60x120 (resized to 64x128), 2
    samples, nearest ordering: the JAX model (``corr_impl="matmul"``, which
    pulls staged views back to the host for the resize) and the port (which
    resizes them where they lie), each through its package's engine, within
    PERF.md §2's limits."""
    check_bridged_robust_mvd_engine(tmp_path, 60, 120)
