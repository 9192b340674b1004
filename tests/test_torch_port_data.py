"""The port's data layer vs the JAX package's (``robustmvd_tpu.data``).

- ``synthetic``: the same samples bit for bit, with and without
  ``input_size`` (the JAX resize with its native library switched off: the
  port has only the numpy resize that is the library's fallback).
- The five Robust MVD sample lists: the port's own copies load without the
  JAX package and give its counts and sample attributes.
- The on-disk fixtures of the first sample of each list (the writers of
  ``tests/test_dataset_fixtures.py``): ``dataset[0]`` bit for bit.
- Registry names, layouts, updates, utilities, the loader and the
  ``dataset.cfg`` round trip.
"""

import os.path as osp
import pickle

import numpy as np
import pytest

import robustmvd_tpu.data as jax_data
import robustmvd_tpu.utils as jax_utils
import robustmvd_tpu_torch.data as data
import robustmvd_tpu_torch.utils as utils
from robustmvd_tpu.data import layouts as jax_layouts
from robustmvd_tpu.data.dataset import load_sample_list as jax_load_sample_list
from robustmvd_tpu.data.transforms import ResizeInputs as JaxResizeInputs
from robustmvd_tpu.data.transforms import ResizeTargets as JaxResizeTargets
from robustmvd_tpu_torch.data import layouts
from robustmvd_tpu_torch.data.dataset import _sample_list_path, load_sample_list
from robustmvd_tpu_torch.data.transforms import ResizeInputs, ResizeTargets
from robustmvd_tpu_torch.data.updates import PickledUpdates

from torch_port_helpers import write_benchmark_fixtures

BENCHMARK = {"kitti": 93, "dtu": 110, "scannet": 200, "tanks_and_temples": 69, "eth3d": 104}


@pytest.fixture
def no_native_resize(monkeypatch):
    """The JAX package's bilinear resize without its native library."""
    import robustmvd_tpu.utils.native as native

    monkeypatch.setattr(native, "resize_bilinear_native", lambda img, size: None)


def assert_samples_equal(ours, ref, path="sample"):
    """Equal structure, types and values, arrays bit for bit (NaN == NaN)."""
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref), path
        for k in ref:
            assert_samples_equal(ours[k], ref[k], f"{path}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(ours) is type(ref) and len(ours) == len(ref), path
        for i, (o, r) in enumerate(zip(ours, ref)):
            assert_samples_equal(o, r, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype, path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert type(ours) is type(ref) and (ours == ref or (ours != ours and ref != ref)), (path, ours, ref)


@pytest.mark.parametrize("input_size", [None, (48, 80), (96, 200)])
def test_synthetic_samples_are_jax_bit_for_bit(no_native_resize, input_size):
    kwargs = dict(num_samples=3, num_views=4, height=40, width=72, keyview_idx=1, input_size=input_size)
    ours, ref = data.create_dataset("synthetic.train.mvd", **kwargs), jax_data.create_dataset("synthetic.train.mvd",
                                                                                             **kwargs)
    assert len(ours) == len(ref) == 3 and ours.name == ref.name == "synthetic.train.mvd"
    for i in range(3):
        assert_samples_equal(ours[i], ref[i])
    if input_size is not None:
        assert ours[0]["images"][0].shape == (3,) + input_size


def test_synthetic_resize_against_the_native_library():
    """With the JAX package's native resize on: within 1e-4 of 255."""
    from robustmvd_tpu.utils.native import get_lib

    if get_lib() is None:
        pytest.skip("the JAX package's native library did not build here")
    kwargs = dict(num_samples=1, num_views=2, height=40, width=72, input_size=(96, 200))
    ours, ref = data.create_dataset("synthetic.train.mvd", **kwargs)[0], jax_data.create_dataset(
        "synthetic.train.mvd", **kwargs)[0]
    for a, b in zip(ours["images"], ref["images"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(BENCHMARK))
def test_sample_lists_match_jax(name):
    """The port's copy of each sample list: JAX's count, sample classes (by
    name, from the port's modules), names, bases and data."""
    path = _sample_list_path(f"{name}.robustmvd.mvd")
    assert osp.realpath(path).startswith(osp.realpath(osp.dirname(data.__file__)))
    ours = load_sample_list(path)
    ref = jax_load_sample_list(osp.join(osp.dirname(jax_data.__file__), "sample_lists",
                                        f"{name}.robustmvd.mvd.pickle"))
    assert len(ours) == len(ref) == BENCHMARK[name]
    assert len(data.create_dataset(f"{name}.robustmvd.mvd", root="/nonexistent", verbose=False)) == BENCHMARK[name]
    for o, r in zip(ours, ref):
        assert type(o).__name__ == type(r).__name__
        assert type(o).__module__.startswith("robustmvd_tpu_torch.data.")
        assert {k: v for k, v in vars(o).items() if k != "data"} == {k: v for k, v in vars(r).items() if k != "data"}
        assert sorted(o.data) == sorted(r.data)
        for key, val in r.data.items():
            items = zip(o.data[key], val) if isinstance(val, list) else [(o.data[key], val)]
            for a, b in items:
                if isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                elif hasattr(b, "__dict__"):
                    assert type(a).__name__ == type(b).__name__ and vars(a) == vars(b)
                else:
                    assert a == b


@pytest.fixture(scope="module")
def fixture_roots(tmp_path_factory):
    return write_benchmark_fixtures(tmp_path_factory.mktemp("benchmark_fixtures"), np.random.RandomState(5))


@pytest.mark.parametrize("name", sorted(BENCHMARK))
def test_fixture_dataset_sample_is_jax_bit_for_bit(fixture_roots, no_native_resize, name):
    """``dataset[0]`` read from the fixture files: every view, the depth, its
    range and the rebased poses equal to the JAX package's."""
    ours = data.create_dataset(f"{name}.robustmvd.mvd", root=fixture_roots[name], verbose=False)[0]
    ref = jax_data.create_dataset(f"{name}.robustmvd.mvd", root=fixture_roots[name], verbose=False)[0]
    assert_samples_equal(ours, ref)
    assert (ours["depth"] > 0).any() and np.isfinite(ours["depth"]).all()


def test_fixture_dataset_with_input_size_is_jax_bit_for_bit(fixture_roots, no_native_resize):
    """KITTI's 21 views resized by ``input_size`` with their intrinsics."""
    kwargs = dict(root=fixture_roots["kitti"], verbose=False, input_size=(48, 128))
    ours, ref = data.create_dataset("kitti.mvd", **kwargs)[0], jax_data.create_dataset("kitti.mvd", **kwargs)[0]
    assert_samples_equal(ours, ref)
    assert ours["images"][0].shape == (3, 48, 128)


def test_dtu_scene_directory_matches_jax(tmp_path, rng):
    """DTU's scene-directory readers: pair.txt (sources padded to 10 by
    repetition), cam files (pose, intrinsics, depth bounds), (view, light)
    image tuples, masks and PFM depths, through a sample with such entries."""
    from test_dataset_fixtures import _write_cam_txt, _write_pfm, _write_png
    from tests_common import random_pose_np

    from robustmvd_tpu.data import dtu as jax_dtu
    from robustmvd_tpu_torch.data import dtu

    base = tmp_path / "scan1"
    H, W, light = 24, 32, 3
    for v in (0, 1):
        _write_png(str(base / f"images/rect_{v:03d}_{light}_r5000.png"), (rng.rand(H, W, 3) * 255).astype(np.uint8))
        K = np.array([[100, 0, W / 2], [0, 100, H / 2], [0, 0, 1]], np.float32)
        _write_cam_txt(str(base / f"cameras/{v:08d}_cam.txt"), random_pose_np(rng), K)
        _write_png(str(base / f"masks/{v:08d}.png"), (rng.rand(H, W) > 0.5).astype(np.uint8) * 255)
    _write_pfm(str(base / "gt_depths/00000000.pfm"), (rng.rand(H, W) * 500 + 400).astype(np.float32))
    with open(base / "cameras" / "pair.txt", "w") as f:
        f.write("2\n0\n1 1 12.5\n1\n1 0 11.0\n")

    outs = []
    for mod in (dtu, jax_dtu):
        pair = mod.DTUPair(str(base / "cameras" / "pair.txt"))
        sample = mod.DTUSample(name="scan1/0", base="scan1")
        sample.data = {"images": [(v, light) for v in (0, 1)], "poses": [0, 1], "intrinsics": [0, 1],
                       "depth": 0, "masks": [0], "keyview_idx": 0}
        outs.append((pair.get_source_ids(0), pair.get_source_scores(1),
                     mod.DTUMinDepth("cameras/00000000_cam.txt").load(str(base)),
                     mod.DTUMaxDepth("cameras/00000000_cam.txt").load(str(base)), sample.load(str(tmp_path))))
    assert outs[0][0] == [1] * 10
    assert_samples_equal(list(outs[0]), list(outs[1]))


@pytest.mark.parametrize("name", ["eth3d.mvd", "kitti.robustmvd.mvd", "dtu.mvd", "scannet.robustmvd",
                                  "tanks_and_temples.robustmvd.mvd", "synthetic.mvd", "synthetic.train",
                                  "nonexistent.mvd", "kitti", "kitti.robustmvd.unknown_type"])
def test_dataset_names_resolve_as_in_jax(name):
    from robustmvd_tpu.data.registry import _build_dataset_name as jax_build
    from robustmvd_tpu_torch.data.registry import _build_dataset_name

    assert data.has_dataset(name) == jax_data.has_dataset(name)
    assert _build_dataset_name(name) == jax_build(name)
    if data.has_dataset(name):
        assert data.create_dataset(name, root="/nonexistent", verbose=False).name == \
            jax_data.create_dataset(name, root="/nonexistent", verbose=False).name


def test_registry_lists_the_evaluation_datasets():
    names = data.list_datasets()
    assert names == ["dtu.robustmvd.mvd", "eth3d.robustmvd.mvd", "kitti.robustmvd.mvd", "scannet.robustmvd.mvd",
                     "synthetic.train.mvd", "tanks_and_temples.robustmvd.mvd"]
    assert set(names) <= set(jax_data.list_datasets())
    assert data.list_base_datasets() == sorted(set(BENCHMARK) | {"synthetic"})
    assert data.list_dataset_types() == ["mvd"] and data.list_splits() == ["robustmvd", "train"]
    assert data.list_datasets(dataset_type="mvd", no_dataset_type=True) == \
        [n[: -len(".mvd")] for n in names]
    with pytest.raises(ValueError):
        data.create_dataset("nonexistent.mvd")


def _layout_pairs():
    return [
        ("sequential", lambda m: m.MVDSequentialDefaultLayout("default", num_views=5, keyview_idx=2)),
        ("unstructured", lambda m: m.MVDUnstructuredDefaultLayout("default", num_views=5, max_views=4)),
        ("eval", lambda m: m.EvalMVDLayout("eval_mvd", eval_uncertainty=True)),
        ("eval_no_uncertainty", lambda m: m.EvalMVDLayout("eval_mvd", eval_uncertainty=False)),
        ("all_images", lambda m: m.AllImagesLayout("all_images", num_views=5)),
    ]


@pytest.mark.parametrize("which,make", _layout_pairs(), ids=[p[0] for p in _layout_pairs()])
def test_layouts_load_what_jax_loads_and_pickle(tmp_path, which, make):
    sample = data.create_dataset("synthetic.train.mvd", num_samples=1, num_views=5, height=16, width=24)[0]
    for key in ("pred_depth", "pred_invdepth", "pointwise_absrel", "pred_depth_uncertainty"):
        sample[key] = np.random.RandomState(0).rand(1, 16, 24).astype(np.float32)
    ours, ref = make(layouts), make(jax_layouts)
    cells = lambda lay: [(v.col, v.row, v.visualization_type, v.name) for v in lay.visualizations]  # noqa: E731
    assert cells(ours) == cells(ref)
    assert_samples_equal(ours.load(sample), ref.load(sample))
    ours.write(str(tmp_path / "layout"))  # the standard library pickles it
    again = layouts.Layout.from_file(str(tmp_path / "layout"))
    assert again.name == ours.name and cells(again) == cells(ours)
    assert_samples_equal(again.load(sample), ref.load(sample))


def test_updates_apply_as_in_jax(tmp_path):
    from robustmvd_tpu.data.updates import PickledUpdates as JaxPickledUpdates

    arr = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    np.save(tmp_path / "pred.npy", arr)
    path = str(tmp_path / "model_eval.pickle")
    with open(path, "wb") as f:
        pickle.dump({1: {"pred_depth": str(tmp_path / "pred.npy"), "absrel": 3.5}}, f)
    ours, ref = PickledUpdates(path), JaxPickledUpdates(path)
    assert ours.name == ref.name == "model_eval" and 1 in ours and 0 not in ours and len(ours) == 1
    a, b = ours.apply_update({"x": 1}, index=1), ref.apply_update({"x": 1}, index=1)
    assert_samples_equal(a, b)
    assert ours.apply_update({"x": 1}, index=0) == {"x": 1}


@pytest.mark.parametrize("case", ["collate", "select_int", "select_batched", "exclude_int", "exclude_batched",
                                  "depth_range", "depth_range_inv", "depth_range_empty", "scale_intrinsics",
                                  "transform", "resize_nearest_up", "resize_nearest_down", "class_name"])
def test_utils_match_jax(case):
    rng = np.random.RandomState(1)
    views = [rng.rand(2, 3, 4).astype(np.float32) for _ in range(3)]
    depth = rng.rand(1, 9, 11).astype(np.float32) * 10 - 1
    depth[0, 0, :3] = [np.nan, np.inf, 0]
    calls = {
        "collate": lambda m: m.numpy_collate([{"a": np.ones(2), "b": [np.zeros(3), 1.5], "c": "x", "d": 3,
                                               "e": np.float64(2.0), "f": None, "g": (1, 2)}] * 2),
        "select_int": lambda m: m.select_by_index(views, 2),
        "select_batched": lambda m: m.select_by_index(views, np.array([2, 0])),
        "exclude_int": lambda m: m.exclude_index(views, 1),
        "exclude_batched": lambda m: m.exclude_index(views, np.array([1, 2])),
        "depth_range": lambda m: m.compute_depth_range(depth=depth),
        "depth_range_inv": lambda m: m.compute_depth_range(invdepth=depth),
        "depth_range_empty": lambda m: m.compute_depth_range(depth=np.zeros((1, 3, 3))),
        "scale_intrinsics": lambda m: m.scale_intrinsics(np.tile(np.eye(3), (2, 1, 1)) * 7, 0.5, 2.0),
        "transform": lambda m: m.transform_from_rot_trans(rng.rand(3, 3), [1, 2, 3]),
        "resize_nearest_up": lambda m: m.resize_nearest(depth, (23, 30)),
        "resize_nearest_down": lambda m: m.resize_nearest(depth, (4, 5)),
        "class_name": lambda m: m.get_full_class_name(np.ndarray),
    }
    state = rng.get_state()
    ours = calls[case](utils)
    rng.set_state(state)
    assert_samples_equal(ours, calls[case](jax_utils))


@pytest.mark.parametrize("order", [0, 1])
def test_resize_transforms_match_jax(no_native_resize, order):
    sample = data.create_dataset("synthetic.train.mvd", num_samples=1, num_views=3, height=20, width=30)[0]
    ref = pickle.loads(pickle.dumps(sample))
    for transform in (ResizeInputs((37, 52), interpolation_order=order), ResizeTargets((11, 17))):
        sample = transform(sample)
    for transform in (JaxResizeInputs((37, 52), interpolation_order=order), JaxResizeTargets((11, 17))):
        ref = transform(ref)
    assert_samples_equal(sample, ref)
    assert sample["depth"].shape == (1, 11, 17) and sample["images"][0].shape == (3, 37, 52)


def test_loader_collates_numpy_batches():
    dataset = data.create_dataset("synthetic.train.mvd", num_samples=5, num_views=2, height=8, width=12)
    batches = list(data.create_dataloader(dataset, batch_size=2))
    assert [b["images"][0].shape for b in batches] == [(2, 3, 8, 12), (2, 3, 8, 12), (1, 3, 8, 12)]
    assert_samples_equal(batches[1], utils.numpy_collate([dataset[2], dataset[3]]))
    shuffled = [b["_index"].tolist() for b in data.create_dataloader(dataset, batch_size=5, shuffle=True, seed=3)]
    again = [b["_index"].tolist() for b in data.create_dataloader(dataset, batch_size=5, shuffle=True, seed=3)]
    assert shuffled == again and sorted(shuffled[0]) == list(range(5))
    subset = dataset.get_loader(batch_size=1, indices=[4, 1])
    assert [b["_index"].tolist() for b in subset] == [[4], [1]]


def test_loader_workers_raise_the_error_of_a_sample():
    """Two spawned workers load KITTI samples whose files do not exist: the
    error reaches the caller (no fallback, no restarted epoch)."""
    dataset = data.create_dataset("kitti.robustmvd.mvd", root="/nonexistent", verbose=False)
    loader = data.create_dataloader(dataset, batch_size=1, num_workers=2)
    with pytest.raises(FileNotFoundError):
        next(iter(loader))


def test_dataset_config_round_trip(tmp_path):
    """``write_config`` / ``create_dataset(path)``: the dataset re-opens with
    its input size, its updates (strict: only the updated samples) and its
    layouts."""
    updates = str(tmp_path / "updates.pickle")
    with open(updates, "wb") as f:
        pickle.dump({2: {"absrel": 1.25}}, f)
    layout_path = str(tmp_path / "layout.pickle")
    layouts.EvalMVDLayout("eval_mvd").write(layout_path)
    cfg = str(tmp_path / "dataset.cfg")
    data.Dataset.write_config(cfg, utils.get_full_class_name(data.SyntheticMVD), input_size=(16, 24),
                              updates=[updates], update_strict=True, layouts=[layout_path])
    dataset = data.create_dataset(cfg)
    assert type(dataset) is data.SyntheticMVD and len(dataset) == 1
    sample = dataset[0]
    assert sample["_index"] == 2 and sample["absrel"] == 1.25 and sample["images"][0].shape == (3, 16, 24)
    assert "eval_mvd" in dataset.get_layout_names() and dataset.full_name == "synthetic.train.mvd+updates"


@pytest.mark.parametrize("module", ["robustmvd_tpu.data.kitti", "rmvd.data.kitti", "rmvd.utils.x",
                                    "numpy._core.multiarray", "torch.utils.data.dataset", "builtins"])
def test_pickled_class_paths_map_onto_the_port(module):
    from robustmvd_tpu_torch.data.dataset import port_module

    root, _, tail = module.partition(".")
    expected = f"robustmvd_tpu_torch.{tail}" if root in ("robustmvd_tpu", "rmvd") else module
    assert port_module(module) == expected
