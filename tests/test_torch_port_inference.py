"""The port's inference CLI on sample_data/ (256x320, key + 3 source views).

``python -m robustmvd_tpu_torch.inference --device cpu`` with a ``.pt``
saved from a seeded port model writes .npy files equal to the port's
``model.run``; the JAX model built from the same ``.pt`` (``corr_impl=
"matmul"``, the JAX package's rmvd checkpoint conversion) agrees within the
model test's bound (per-pixel relative depth error, mean <= 1e-4 where
invdepth > 0). The PNGs are the JAX package's ``vis`` pixel for pixel.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.utils.vis import vis as jax_vis
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.inference import load_data
from robustmvd_tpu_torch.utils import resize_bilinear
from robustmvd_tpu_torch.utils.vis import vis

ROOT = Path(__file__).resolve().parents[1]
SAMPLE = ROOT / "sample_data"


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inference")
    weights = tmp / "robust_mvd.pt"
    model = create_model("robust_mvd", device="cpu", seed=1)
    torch.save({"model_state_dict": model.state_dict()}, weights)
    out = tmp / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "robustmvd_tpu_torch.inference", "--model", "robust_mvd",
         "--input_path", str(SAMPLE), "--output_path", str(out), "--weights", str(weights),
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return model, weights, out


def test_cli_writes_what_model_run_gives(cli_run):
    model, _, out = cli_run
    sample, h, w = load_data(str(SAMPLE))
    assert (h, w) == (256, 320) and len(sample["images"]) == 4
    pred, _ = model.run(**sample)
    depth = resize_bilinear(pred["depth"], (h, w))[0]
    np.testing.assert_allclose(np.load(out / "depth.npy"), depth, rtol=1e-6, atol=0)
    unc = resize_bilinear(pred["depth_uncertainty"], (h, w))[0]
    np.testing.assert_allclose(np.load(out / "depth_uncertainty.npy"), unc, rtol=1e-6, atol=0)
    for name in ("depth", "invdepth", "depth_uncertainty"):
        assert np.isfinite(np.load(out / f"{name}.npy")).all()
        assert (out / f"{name}.png").stat().st_size > 0


def test_cli_agrees_with_jax_on_the_same_checkpoint(cli_run):
    _, weights, out = cli_run
    sample, h, w = load_data(str(SAMPLE))
    jax_model = jax_create_model("robust_mvd", weights=str(weights), corr_impl="matmul")
    ref_pred, ref_aux = jax_model.run(**sample)
    ref_depth = resize_bilinear(ref_pred["depth"], (h, w))[0]
    ref_inv = resize_bilinear(np.asarray(ref_aux["invdepth"]), (h, w))[0]
    depth = np.load(out / "depth.npy")
    valid = ref_inv > 0
    assert valid.mean() > 0.2
    rel = np.abs(depth - ref_depth) / ref_depth
    assert rel[valid].mean() <= 1e-4, rel[valid].mean()


def test_load_data_matches_the_jax_cli():
    sys.path.insert(0, str(ROOT))
    try:
        import inference as jax_cli
    finally:
        sys.path.remove(str(ROOT))
    ours, h, w = load_data(str(SAMPLE))
    ref, rh, rw = jax_cli.load_data(str(SAMPLE))
    assert (h, w) == (rh, rw) and ours["keyview_idx"] == ref["keyview_idx"]
    for key in ("images", "poses", "intrinsics"):
        for a, b in zip(ours[key], ref[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["random", "nonfinite", "constant"])
def test_vis_matches_jax(kind):
    rng = np.random.RandomState(0)
    arr = rng.rand(40, 56).astype(np.float32) * 10
    if kind == "nonfinite":
        arr[3, 4], arr[5, 6], arr[7, 8] = np.nan, np.inf, -np.inf
    elif kind == "constant":
        arr[:] = 2.5
    np.testing.assert_array_equal(np.array(vis(arr)), np.array(jax_vis(arr)))
    np.testing.assert_array_equal(np.array(vis(arr[None])), np.array(jax_vis(arr[None])))


@pytest.fixture(scope="module")
def mvsnet_cli_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inference_mvsnet")
    weights = tmp / "mvsnet_train.pt"
    model = create_model("mvsnet_train", device="cpu", seed=2)
    torch.save({"model_state_dict": model.state_dict()}, weights)
    out = tmp / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "robustmvd_tpu_torch.inference", "--model", "mvsnet_train",
         "--input_path", str(SAMPLE), "--output_path", str(out), "--weights", str(weights),
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return model, out


def test_mvsnet_cli_writes_what_model_run_gives(mvsnet_cli_run):
    """mvsnet_train through the CLI (full width, 256 hypotheses, depth range
    defaulting to 0.2..100 as in the JAX module) equals ``model.run``."""
    model, out = mvsnet_cli_run
    sample, h, w = load_data(str(SAMPLE))
    pred, _ = model.run(**sample)
    assert pred["depth"].shape == (1, 64, 80)
    for name in ("depth", "depth_uncertainty"):
        ref = resize_bilinear(pred[name], (h, w))[0]
        np.testing.assert_allclose(np.load(out / f"{name}.npy"), ref, rtol=1e-6, atol=0)
        assert np.isfinite(ref).all() and (out / f"{name}.png").stat().st_size > 0


def test_mvsnet_cli_agrees_with_jax(mvsnet_cli_run):
    """The JAX module (``warp_impl="xla"``) with the CLI model's weights on
    the same sample: per-pixel relative depth error mean <= 1e-5, max <= 1e-4
    (the bound of tests/test_torch_port_mvsnet.py)."""
    from robustmvd_tpu.models.mvsnet import MVSNet as JaxMVSNet
    from robustmvd_tpu.models.mvsnet import MVSNetModule
    from robustmvd_tpu_torch.models.weights import variables_from_state_dict
    from robustmvd_tpu_torch.utils import add_batch_dim

    model, out = mvsnet_cli_run
    sample, h, w = load_data(str(SAMPLE))
    images, keyview_idx, poses, intrinsics = add_batch_dim(
        [sample["images"], sample["keyview_idx"], sample["poses"], sample["intrinsics"]])
    # the adapter uses no state; the module runs without the JAX model's init
    inputs = JaxMVSNet.input_adapter(None, images=images, keyview_idx=keyview_idx, poses=poses,
                                     intrinsics=intrinsics)
    module = MVSNetModule(num_sampling_steps=256, warp_impl="xla", conv3d_impl="xla")
    ref_pred, _ = module.apply(variables_from_state_dict(model.state_dict()), **inputs)
    ref_depth = resize_bilinear(np.asarray(ref_pred["depth"])[..., 0], (h, w))[0]
    depth = np.load(out / "depth.npy")
    assert ref_depth.std() > 1e-3 * ref_depth.mean()
    rel = np.abs(depth - ref_depth) / ref_depth
    assert rel.mean() <= 1e-5 and rel.max() <= 1e-4, (rel.mean(), rel.max())


def pinned_threads_env():
    """Pin this process's CPU thread count and give the CLI subprocess the
    same count, with MKL's dynamic thread choice off in both
    (``torch.set_num_threads`` turns it off here, ``MKL_DYNAMIC`` there).
    oneDNN's convolutions split their sums by the thread count, and
    vis_mvsnet's random-weight cascade turns those rounding differences
    into depth differences of ~1e-3 relative."""
    n = torch.get_num_threads()
    torch.set_num_threads(n)
    return {**os.environ, "OMP_NUM_THREADS": str(n), "MKL_NUM_THREADS": str(n), "MKL_DYNAMIC": "FALSE"}


@pytest.fixture(scope="module")
def vis_cli_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inference_vis")
    weights = tmp / "vis_mvsnet.pt"
    model = create_model("vis_mvsnet", device="cpu", seed=4)
    torch.save({"model_state_dict": model.state_dict()}, weights)
    out = tmp / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "robustmvd_tpu_torch.inference", "--model", "vis_mvsnet",
         "--input_path", str(SAMPLE), "--output_path", str(out), "--weights", str(weights),
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=pinned_threads_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return model, out


def test_vis_cli_writes_what_model_run_gives(vis_cli_run):
    """vis_mvsnet through the CLI (full width, 1+3 views, depth range
    defaulting to 0.2..100) equals ``model.run`` with the same pinned CPU
    thread count (``pinned_threads_env``): depth at half the input
    resolution, resized back."""
    model, out = vis_cli_run
    sample, h, w = load_data(str(SAMPLE))
    pred, _ = model.run(**sample)
    assert pred["depth"].shape == (1, h // 2, w // 2)
    for name in ("depth", "depth_uncertainty"):
        ref = resize_bilinear(pred[name], (h, w))[0]
        np.testing.assert_allclose(np.load(out / f"{name}.npy"), ref, rtol=1e-6, atol=0)
        assert np.isfinite(ref).all() and (out / f"{name}.png").stat().st_size > 0
