"""The training datasets' readers of the port vs the JAX package's

(robustmvd_tpu_torch/data/{seqconf,staticthings3d,blendedmvs,flyingthings3d}.py,
KITTI's Eigen dense-depth splits, DTU's MVSNet training split). No training
data exists on the machine, so each test writes fixture files in the
dataset's raw format with the writers of ``tests/test_dataset_fixtures.py``
(the layouts of its generation tests), builds the dataset in both packages
over them and holds ``dataset[0]`` bit-equal. The sequence and scene
datasets generate their sample lists from the root and cache them in the
package; the tests redirect those caches into a temporary directory, so
that no package directory is written. Last, the train CLI takes the paper
recipe's steps on the StaticThings3D + BlendedMVS compound of fixtures, at
float32 and at bf16.
"""

import copy
import os
import os.path as osp
import pickle

import numpy as np
import pytest

import robustmvd_tpu.data as jdata
import robustmvd_tpu_torch.data as pdata
from test_dataset_fixtures import _write_cam_txt, _write_float3, _write_jpg, _write_pfm, _write_png
from tests_common import random_pose_np

# the names whose sample lists the tests write or generate (the rest are the packages' own)
GENERATED = ("staticthings3d.robust_mvd.mvd", "blendedmvs.robust_mvd.mvd", "blendedmvs.train_mvsnet.mvd",
             "flyingthings3d.robust_mvd.mvd", "kitti.eigen_dense_depth_test.mvd", "kitti.eigen_dense_depth_train.mvd")
MODULES = ("dataset", "staticthings3d", "blendedmvs", "flyingthings3d")


@pytest.fixture
def list_dirs(tmp_path, monkeypatch):
    """Each package's sample-list path for the GENERATED names, redirected to
    a directory of its own under tmp_path: {"jax": dir, "port": dir}."""
    import importlib

    dirs = {}
    for label, package in (("jax", "robustmvd_tpu"), ("port", "robustmvd_tpu_torch")):
        dirs[label] = tmp_path / f"lists_{label}"
        dirs[label].mkdir()
        original = importlib.import_module(f"{package}.data.dataset")._sample_list_path

        def redirected(name, _dir=dirs[label], _original=original):
            return str(_dir / f"{name}.pickle") if name in GENERATED else _original(name)

        for module in MODULES:
            monkeypatch.setattr(importlib.import_module(f"{package}.data.{module}"), "_sample_list_path", redirected)
    return dirs


def assert_bit_equal(ours, ref, where="sample"):
    assert type(ours) is type(ref), f"{where}: {type(ours)} vs {type(ref)}"
    if isinstance(ref, dict):
        assert set(ours) == set(ref), where
        for key in ref:
            assert_bit_equal(ours[key], ref[key], f"{where}[{key!r}]")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (o, r) in enumerate(zip(ours, ref)):
            assert_bit_equal(o, r, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, where
        np.testing.assert_array_equal(ours, ref, err_msg=where)
    else:
        assert ours == ref, where


def write_staticthings3d(root, rng, H=16, W=24, frames=9):
    """``<root>/TRAIN/A/0000``: frames 0..8 of png, float3 depth, K, pose
    (tests/test_dataset_fixtures.py:488); the dataset root is ``<root>/TRAIN``."""
    seq = root / "TRAIN" / "A" / "0000"
    K = np.array([[20, 0, W / 2], [0, 20, H / 2], [0, 0, 1]], np.float32)
    for fn in range(frames):
        _write_png(str(seq / "frames_cleanpass" / "left" / f"{fn:04d}.png"), (rng.rand(H, W, 3) * 255).astype(np.uint8))
        depth = (rng.rand(H, W) * 30 + 1).astype(np.float32)
        depth[0, :2] = [-1.0, np.inf]  # invalid -> 0
        _write_float3(str(seq / "depths" / "left" / f"{fn:04d}.float3"), depth)
        _write_float3(str(seq / "intrinsics" / "left" / f"{fn:04d}.float3"), K)
        _write_float3(str(seq / "poses" / "left" / f"{fn:04d}.float3"), random_pose_np(rng))
    return root / "TRAIN"


def write_blendedmvs(root, rng, H=16, W=24):
    """One training scene of 5 views with masked jpgs, cam files, PFM depths
    and a pair.txt of two key views (tests/test_dataset_fixtures.py:539)."""
    base = root / jdata.blendedmvs.BMVS_TRAIN_SCENES[0]
    for v in range(5):
        _write_jpg(str(base / "blended_images" / f"{v:08d}_masked.jpg"), (rng.rand(H, W, 3) * 255).astype(np.uint8))
        _write_cam_txt(str(base / "cams" / f"{v:08d}_cam.txt"), random_pose_np(rng),
                       np.array([[20, 0, W / 2], [0, 20, H / 2], [0, 0, 1]], np.float32),
                       depth_line="0.8 0.01 128 2.08")
        depth = (rng.rand(H, W) * 2 + 0.8).astype(np.float32)
        depth[0, 0] = np.nan
        _write_pfm(str(base / "rendered_depth_maps" / f"{v:08d}.pfm"), depth)
    with open(base / "cams" / "pair.txt", "w") as f:
        f.write("2\n0\n4 1 9.0 2 8.0 3 7.0 4 6.0\n1\n4 0 9.0 2 8.0 3 7.0 4 6.0\n")
    return root


def write_flyingthings3d(root, rng, H=16, W=24):
    """Frames 0..8 with png, PFM disparity, npy K and pose
    (tests/test_dataset_fixtures.py:593)."""
    seq = root / "TRAIN" / "A" / "0000"
    K = np.array([[1050, 0, W / 2], [0, 1050, H / 2], [0, 0, 1]], np.float32)
    for fn in range(9):
        _write_png(str(seq / "frames_cleanpass" / "left" / f"{fn:04d}.png"), (rng.rand(H, W, 3) * 255).astype(np.uint8))
        disp = -(rng.rand(H, W) * 50 + 10).astype(np.float32)
        disp[0, 0] = 0.0  # inf depth -> 0
        _write_pfm(str(seq / "disparities" / "left" / f"{fn:04d}.pfm"), disp)
        for kind, value in (("intrinsics", K), ("poses", random_pose_np(rng))):
            os.makedirs(seq / kind / "left", exist_ok=True)
            np.save(str(seq / kind / "left" / f"{fn:04d}.npy"), value)
    return root / "TRAIN"


def write_kitti_eigen(root, rng, list_dirs, name, H=24, W=80):
    """A one-sample list of KITTI's Eigen split (the JAX package's classes,
    pickled, as a user-generated list holds them) and its files: an RGB png
    and a 16-bit depth png (depth * 256, 0 invalid)."""
    from robustmvd_tpu.data.kitti import KITTIDepth, KITTIImage, KITTISample

    drive = "2011_09_26/2011_09_26_drive_0002_sync"
    image = f"{drive}/image_02/data/0000000005.png"
    depth_path = f"{drive}/proj_depth/groundtruth/image_02/0000000005.png"
    _write_png(str(root / image), (rng.rand(H, W, 3) * 255).astype(np.uint8))
    depth = (rng.rand(H, W) * 40 + 2) * 256
    depth[:2] = 0
    _write_png(str(root / depth_path), depth.astype(np.uint16))
    sample = KITTISample(name=f"{drive}/0000000005")
    sample.data = {"images": [KITTIImage(image)], "depth": KITTIDepth(depth_path),
                   "poses": [np.eye(4, dtype=np.float32)],
                   "intrinsics": [np.array([[721.5, 0, 40.0], [0, 721.5, 12.0], [0, 0, 1]], np.float32)],
                   "keyview_idx": 0}
    for d in list_dirs.values():
        with open(d / f"{name}.pickle", "wb") as f:
            pickle.dump([sample], f)
    return root


def write_dtu_mvsnet_train(root, rng, H=16, W=24):
    """The files of sample 0 of ``dtu.train_mvsnet.mvd`` (the bundled list):
    its scan's rectified images of light 0, cam files, PFM depth and mask."""
    sample = copy.deepcopy(jdata.create_dataset("dtu.train_mvsnet.mvd", root="/nonexistent", verbose=False).samples[0])
    base = root / sample.base
    for view_id, light in sample.data["images"]:
        _write_png(str(base / "images" / f"rect_{view_id:03d}_{light}_r5000.png"),
                   (rng.rand(H, W, 3) * 255).astype(np.uint8))
    for view_id in sample.data["poses"]:
        _write_cam_txt(str(base / "cameras" / f"{view_id:08d}_cam.txt"), random_pose_np(rng),
                       np.array([[30, 0, W / 2], [0, 30, H / 2], [0, 0, 1]], np.float32))
    depth = (rng.rand(H, W) * 500 + 400).astype(np.float32)
    depth[:2] = np.nan
    _write_pfm(str(base / "gt_depths" / f"{sample.data['depth']:08d}.pfm"), depth)
    _write_png(str(base / "masks" / f"{sample.data['masks']:08d}.png"), ((rng.rand(H, W) > 0.3) * 255).astype(np.uint8))
    return root


def test_list_datasets_equals_jax():
    assert sorted(pdata.list_datasets()) == sorted(jdata.list_datasets())
    assert len(pdata.list_datasets()) == 13
    for kw in ({"dataset_type": "mvd"}, {"base_dataset": "blendedmvs"}, {"split": "robust_mvd"}):
        assert sorted(pdata.list_datasets(**kw)) == sorted(jdata.list_datasets(**kw))


def test_dtu_mvsnet_train_list_is_the_jax_list():
    with open(pdata.dataset._sample_list_path("dtu.train_mvsnet.mvd"), "rb") as f:
        ours = f.read()
    with open(jdata.dataset._sample_list_path("dtu.train_mvsnet.mvd"), "rb") as f:
        assert ours == f.read()
    assert len(pdata.create_dataset("dtu.train_mvsnet.mvd", root="/nonexistent", verbose=False)) == 27097


@pytest.mark.parametrize("name", ["staticthings3d.robust_mvd.mvd", "blendedmvs.robust_mvd.mvd",
                                  "blendedmvs.train_mvsnet.mvd", "flyingthings3d.robust_mvd.mvd",
                                  "kitti.eigen_dense_depth_test.mvd", "kitti.eigen_dense_depth_train.mvd",
                                  "dtu.train_mvsnet.mvd"])
def test_first_sample_is_bit_equal_to_jax(tmp_path, list_dirs, name, rng):
    data = tmp_path / "data"
    base = name.split(".")[0]
    if base == "staticthings3d":
        root = write_staticthings3d(data, rng)
    elif base == "blendedmvs":
        root = write_blendedmvs(data, rng)
    elif base == "flyingthings3d":
        root = write_flyingthings3d(data, rng)
    elif base == "kitti":
        root = write_kitti_eigen(data, rng, list_dirs, name)
    else:
        root = write_dtu_mvsnet_train(data, rng)
    ref = jdata.create_dataset(name, root=str(root), verbose=False)
    ours = pdata.create_dataset(name, root=str(root), verbose=False)
    assert type(ours).__name__ == type(ref).__name__ and ours.name == ref.name == name
    assert len(ours) == len(ref) > 0
    if base in ("staticthings3d", "blendedmvs", "flyingthings3d"):
        # each package generated its own list from the fixture tree and cached it
        assert osp.isfile(list_dirs["port"] / f"{name}.pickle") and osp.isfile(list_dirs["jax"] / f"{name}.pickle")
    sample = ours[0]
    assert_bit_equal(sample, ref[0])
    assert sample["depth"].shape[0] == 1 and (sample["depth"] == 0).any()  # invalid depth scrubbed
    assert len(sample["images"]) == {"staticthings3d": 5, "blendedmvs": 5 if "robust" in name else 3,
                                     "flyingthings3d": 5, "kitti": 1, "dtu": 3}[base]


def test_sample_counts_of_the_generated_splits(tmp_path, list_dirs, rng):
    """The generation tests' counts (tests/test_dataset_fixtures.py:523, 573):
    StaticThings3D's keyframes 6..8 of 9 frames give C(8,4) + C(7,4) + C(6,4),
    BlendedMVS's 2 keys x C(10,4) padded combinations, every 2nd one."""
    st3d = pdata.create_dataset("staticthings3d.robust_mvd.mvd", root=str(write_staticthings3d(tmp_path / "a", rng)),
                                verbose=False)
    assert len(st3d) == 70 + 35 + 15
    bmvs = pdata.create_dataset("blendedmvs.robust_mvd.mvd", root=str(write_blendedmvs(tmp_path / "b", rng)),
                                verbose=False)
    assert len(bmvs) == 210
    # the cached list is read back by the next dataset of that name
    again = pdata.create_dataset("blendedmvs.robust_mvd.mvd", root=str(tmp_path / "b"), verbose=False)
    assert [s.name for s in again.samples] == [s.name for s in bmvs.samples]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_cli_takes_recipe_steps_on_the_compound(tmp_path, list_dirs, monkeypatch, dtype):
    """``python -m robustmvd_tpu_torch.train`` with the recipe (train_all.sh:8-18)
    over ``staticthings3d.robust_mvd.mvd`` + ``blendedmvs.robust_mvd.mvd`` as one
    ``--dataset`` flag with two values, each with its augmentations (384x768
    crops), batch 1, two steps; the roots come from the user's paths file."""
    import torch

    import robustmvd_tpu_torch.utils.paths as paths
    from robustmvd_tpu_torch.train.cli import main as train_main

    rng = np.random.RandomState(5)
    st3d = write_staticthings3d(tmp_path / "st3d", rng, H=54, W=96)
    bmvs = write_blendedmvs(tmp_path / "bmvs", rng, H=48, W=64)
    paths_file = tmp_path / "rmvd_data_paths.toml"
    paths_file.write_text(f'[staticthings3d.train]\nroot = "{st3d}"\n\n[blendedmvs]\nroot = "{bmvs}"\n')
    monkeypatch.setattr(paths, "USER_PATHS_FILE", paths_file)
    out = tmp_path / "out"
    train_main(["--training_type", "mvd", "--output", str(out), "--model", "robust_mvd", "--dtype", dtype,
                "--inputs", "poses", "intrinsics", "--optimizer", "adam", "--lr", "1e-4",
                "--grad_clip_max_norm", "5", "--scheduler", "flownet_scheduler", "--loss", "robust_mvd_loss",
                "--batch_size", "1", "--max_iterations", "2", "--log_interval", "1",
                "--dataset", "staticthings3d.robust_mvd.mvd", "blendedmvs.robust_mvd.mvd",
                "--augmentations_per_dataset", "robust_mvd_augmentations_staticthings3d",
                "robust_mvd_augmentations_blendedmvs",
                "--batch_augmentations", "robust_mvd_batch_augmentations", "--num_workers", "0", "--device", "cpu"])
    snapshot = torch.load(out / "checkpoints" / "snapshot-iter-000000002.pt", weights_only=False)
    assert snapshot["iteration"] == 2
    state = snapshot["model"]
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in state.values())
    log = (out / "log.txt").read_text()
    # both readers in the compound: 120 StaticThings3D + 210 BlendedMVS samples
    assert "Dataset: staticthings3d.robust_mvd.mvd+blendedmvs.robust_mvd.mvd (330 samples)" in log, log[:2000]
    losses = [float(line.split("loss: ")[1].split()[0]) for line in log.splitlines() if "- loss: " in line]
    assert len(losses) >= 2 and np.isfinite(losses).all(), losses
