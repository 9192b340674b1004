"""The slice as a whole: robust_mvd inference in the port vs the JAX package.

Full architecture (DispNet widths 64 ... 1024, S = 256 hypotheses), weights
from the JAX ``init`` bridged into the port, B = 1, 64x128, key + 3 source
views, both through ``model.run``. The JAX input adapter pads the 3 source
views to a bucket of 4 and masks the pad; the port does not pad.

Bounds, as mean|d| / mean|ref| and max|d| / mean|ref|:
- vs JAX ``corr_impl="matmul"`` and ``"pallas"`` (the port's route):
  mean <= 1e-4, max <= 1e-3 (fp32 sum order through ~40 convolutions);
- vs the JAX default ``"pixelscan"``: mean <= 5e-3, its documented
  tolerance near the epipole (robustmvd_tpu/models/robust_mvd.py:85-88).
Depth = 1/(invdepth + 1e-9) is held per pixel, as the benchmark's absrel
holds it: |d| / depth_ref, mean over pixels with invdepth > 0 and max over
the model's depth range (invdepth >= 1/1000). Past that range a tiny
invdepth turns a 1e-7 absolute difference into a large relative one.
"""

import numpy as np
import pytest

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu_torch import create_model

from torch_port_helpers import load_bridged, mvd_sample, relative_errors

BOUNDS = {"matmul": (1e-4, 1e-3), "pallas": (1e-4, 1e-3), "pixelscan": (5e-3, None)}


@pytest.fixture(scope="module")
def sample():
    return mvd_sample(np.random.RandomState(7), 64, 128, num_views=4)


@pytest.fixture(scope="module")
def jax_variables():
    return jax_create_model("robust_mvd", pretrained=False, corr_impl="matmul").variables


@pytest.fixture(scope="module")
def port_output(sample, jax_variables):
    model = load_bridged(create_model("robust_mvd", device="cpu"), jax_variables)
    return model.run(**sample)


def _check(ours, ref, bounds, what):
    assert ours.shape == ref.shape, what
    mean, mx = relative_errors(ours, ref)
    assert mean <= bounds[0], f"{what}: mean rel err {mean:.3g} > {bounds[0]}"
    if bounds[1] is not None:
        assert mx <= bounds[1], f"{what}: max rel err {mx:.3g} > {bounds[1]}"


@pytest.mark.parametrize("impl", ["matmul", "pallas", "pixelscan"])
def test_robust_mvd_matches_jax(sample, jax_variables, port_output, impl):
    model = jax_create_model("robust_mvd", pretrained=False, corr_impl=impl)
    model.variables = jax_variables
    ref_pred, ref_aux = model.run(**sample)
    pred, aux = port_output
    bounds = BOUNDS[impl]

    for key in ("invdepths_all", "invdepth_log_bs_all"):
        assert len(aux[key]) == len(ref_aux[key]) == 6
        for scale, (o, r) in enumerate(zip(aux[key], ref_aux[key])):
            _check(o, np.asarray(r), bounds, f"{key}[{scale}]")

    invdepth = np.asarray(ref_aux["invdepth"])
    assert invdepth.shape == (1, 1, 32, 64)
    assert (invdepth > 0).mean() > 0.2  # the comparison is not vacuous
    depth, ref_depth = pred["depth"], ref_pred["depth"]
    rel = np.abs(depth - ref_depth) / ref_depth
    assert rel[invdepth > 0].mean() <= bounds[0], rel[invdepth > 0].mean()
    if bounds[1] is not None:
        assert rel[invdepth >= 1e-3].max() <= bounds[1], rel[invdepth >= 1e-3].max()
    assert np.isfinite(pred["depth"]).all() and np.isfinite(pred["depth_uncertainty"]).all()


def test_one_source_view_runs_the_fusion_pass_through(sample, jax_variables):
    """1 + 1 views: LearnedFusion passes the single view through."""
    one = {k: (v[:2] if isinstance(v, list) else v) for k, v in sample.items()}
    model = jax_create_model("robust_mvd", pretrained=False, corr_impl="matmul")
    model.variables = jax_variables
    _, ref_aux = model.run(**one)
    port = load_bridged(create_model("robust_mvd", device="cpu"), jax_variables)
    _, aux = port.run(**one)
    _check(aux["invdepth"], np.asarray(ref_aux["invdepth"]), BOUNDS["matmul"], "invdepth")
