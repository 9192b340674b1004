"""The port's evaluation vs the JAX package's (``robustmvd_tpu.eval``).

- Metrics and AUSE on random arrays with masks: equal to 1e-6.
- The engine (``create_evaluation("mvd")``) over ``synthetic`` (5 views,
  64x128, 4 samples) with a deterministic numpy model, for both view
  orderings and the three alignments: JAX's results table (runtime and
  memory columns aside), sparsification curves and qualitatives, to 1e-6.
- The engine with ``robust_mvd`` at full width, the JAX model
  (``corr_impl="matmul"``) and the port with the same weights: the metrics
  within the parity limits of PERF.md §2 (mean relative error <= 1e-4, max
  <= 1e-3; the 1.03-inlier ratio, a count of pixels on one side of a
  threshold, within a share of 1e-3 of the pixels: a depth that differs by
  1e-6 moves the pixels that lie that close to the threshold).
- ``create_evaluation("robustmvd")`` over on-disk fixtures of the five
  datasets: JAX's table and the same CSV files.
- ``python -m robustmvd_tpu_torch.eval --device cpu`` writes the
  ``results.csv`` of the library call.
"""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import robustmvd_tpu.data as jax_data
import robustmvd_tpu_torch.data as data
from robustmvd_tpu import create_model as jax_create_model
from robustmvd_tpu.eval import create_evaluation as jax_create_evaluation
from robustmvd_tpu.eval import metrics as jax_metrics
from robustmvd_tpu_torch import create_model
from robustmvd_tpu_torch.eval import create_evaluation, metrics

from test_torch_port_inference import pinned_threads_env
from torch_port_helpers import load_bridged, relative_errors, write_benchmark_fixtures

ROOT = Path(__file__).resolve().parents[1]
TIMING = ["runtime_model_in_sec", "runtime_model_in_msec", "runtime_model_and_io_in_sec",
          "runtime_model_and_io_in_msec", "device_mem_peak_in_mib"]
LIMITS = (1e-4, 1e-3)  # PERF.md §2: mean, max relative error
INLIER_FLIP_SHARE = 1e-3  # PERF.md §2: the inlier ratio, a count over a threshold, by the share of pixels moved


class DuckModel:
    """A deterministic numpy model with the run protocol: depth from the
    key image, the mean of all views and the baselines (more views, a
    smoother depth but a larger offset), at half resolution; an uncertainty
    from the depth and the key image."""

    name = "duck"

    def input_adapter(self, images, keyview_idx, poses=None, intrinsics=None, depth_range=None):
        return {"images": np.stack(images, 1), "poses": np.stack(poses, 1), "keyview_idx": keyview_idx}

    def __call__(self, images, poses, keyview_idx):
        key = images[:, int(keyview_idx[0])]
        shade = 0.7 * key[:, :1] + 0.3 * images.mean(axis=1)[:, :1]
        depth = 2.0 + 8.0 * shade / 255.0 - 2.0 * np.abs(poses[:, :, :3, 3]).sum(axis=(1, 2))[:, None, None, None]
        unc = np.abs(depth - 6.0) + 0.1 * key[:, 1:2] / 255.0
        return {"depth": depth[..., ::2, ::2].astype(np.float32),
                "depth_uncertainty": unc[..., ::2, ::2].astype(np.float32)}, {}

    def output_adapter(self, output):
        return output


def without_timing(df):
    return df.drop(columns=TIMING, level="metric", errors="ignore")


def _metric_inputs(masked):
    rng = np.random.RandomState(11)
    gt = rng.rand(40, 60).astype(np.float32) * 10
    gt[rng.rand(40, 60) < 0.2] = 0  # invalid ground truth
    pred = gt * (1 + 0.1 * rng.randn(40, 60)).astype(np.float32)
    pred[0, :5] = [0, np.inf, -1, np.nan, 1e-9]
    unc = rng.rand(40, 60).astype(np.float32)
    mask = (rng.rand(40, 60) > 0.3).astype(np.float32) if masked else None
    return gt, pred, unc, mask


METRIC_CALLS = {
    "valid_mean": lambda m, gt, pred, unc, mask: m.valid_mean(pred, gt > 0 if mask is None else mask),
    "thresh_inliers": lambda m, gt, pred, unc, mask: m.thresh_inliers(gt, pred, 1.03, mask, 100.0),
    "m_rel_ae": lambda m, gt, pred, unc, mask: m.m_rel_ae(gt, pred, mask, 100.0),
    "pointwise_rel_ae": lambda m, gt, pred, unc, mask: m.pointwise_rel_ae(gt, pred, mask),
    "sparsification": lambda m, gt, pred, unc, mask: m.sparsification(gt, pred, unc, mask),
    "ause": lambda m, gt, pred, unc, mask: m.ause(gt, pred, unc, mask),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", sorted(METRIC_CALLS))
def test_metrics_match_jax(fn, masked):
    args = _metric_inputs(masked)
    ours, ref = METRIC_CALLS[fn](metrics, *args), METRIC_CALLS[fn](jax_metrics, *args)
    ours, ref = (ours, ref) if isinstance(ref, tuple) else ((ours,), (ref,))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(o, np.float64), np.asarray(r, np.float64), rtol=1e-6, atol=0)
    if fn == "ause":
        assert np.isfinite(ours[0]) and ours[0] > 0


def _run_both(tmp_path, dataset_kwargs, port_model, jax_model, call_kwargs, **eval_kwargs):
    out = {}
    for label, make_eval, make_data, model in (("port", create_evaluation, data.create_dataset, port_model),
                                               ("jax", jax_create_evaluation, jax_data.create_dataset, jax_model)):
        evaluation = make_eval("mvd", out_dir=str(tmp_path / label), verbose=False, **eval_kwargs)
        out[label] = evaluation(dataset=make_data("synthetic.train.mvd", **dataset_kwargs), model=model,
                                **call_kwargs)
    return out["port"], out["jax"]


@pytest.mark.parametrize("alignment", [None, "median", "least_squares_scale_shift"])
@pytest.mark.parametrize("ordering", ["quasi-optimal", "nearest"])
def test_engine_with_a_numpy_model_gives_jax_results(tmp_path, ordering, alignment):
    ours, ref = _run_both(tmp_path, dict(num_samples=4, num_views=5, height=64, width=128), DuckModel(),
                          DuckModel(), dict(qualitatives=2, burn_in_samples=1), inputs=["poses"],
                          view_ordering=ordering, alignment=alignment)
    assert ours.shape == ref.shape and ours.shape[0] == 4
    pd.testing.assert_frame_equal(without_timing(ours), without_timing(ref), check_exact=False, rtol=1e-6, atol=0)
    assert (ours["best"]["num_views"] > 1).any()  # the sweep's choice is not the first run's
    # the engine's own timing: NaN for the burn-in sample, measured after it; no card, no memory figure
    runtimes = ours.loc[:, (slice(None), "runtime_model_in_msec")]
    assert runtimes.loc[0].isna().all() and np.isfinite(runtimes.loc[1:].to_numpy(np.float64)).all()
    assert ours.loc[:, (slice(None), "device_mem_peak_in_mib")].isna().all().all()
    for name in ("sparsification_curves.pickle", "num_source_view_results.pickle"):
        a, b = (pd.read_pickle(tmp_path / label / "per_sample" / name) for label in ("port", "jax"))
        pd.testing.assert_frame_equal(without_timing(a) if "num_source" in name else a,
                                      without_timing(b) if "num_source" in name else b,
                                      check_exact=False, rtol=1e-6, atol=0)
    quals = sorted(p.name for p in (tmp_path / "port" / "qualitative").glob("*.npy"))
    assert quals == sorted(p.name for p in (tmp_path / "jax" / "qualitative").glob("*.npy")) and len(quals) == 8
    for name in quals:
        np.testing.assert_allclose(np.load(tmp_path / "port" / "qualitative" / name),
                                   np.load(tmp_path / "jax" / "qualitative" / name), rtol=1e-6, atol=0)
    # the evaluation's dataset.cfg re-opens the dataset with its predictions on the updated samples
    reopened = data.create_dataset(str(tmp_path / "port" / "qualitative" / "dataset.cfg"))
    sample = reopened[0]
    assert "pred_depth" in sample and sample["pred_depth"].shape == (1, 64, 128)
    assert "eval_mvd" in reopened.get_layout_names()


def test_engine_resumes_from_its_results_file(tmp_path):
    """A second call with the same output directory returns the stored table."""
    evaluation = create_evaluation("mvd", out_dir=str(tmp_path), inputs=["poses"], verbose=False)
    dataset = data.create_dataset("synthetic.train.mvd", num_samples=2, num_views=3, height=16, width=24)
    first = evaluation(dataset=dataset, model=DuckModel(), qualitatives=0)
    again = evaluation(dataset=None, model=None)
    pd.testing.assert_frame_equal(first, again)


def test_engine_with_bridged_robust_mvd_agrees_with_jax(tmp_path):
    """robust_mvd at full width, 3 views at 64x128, 2 samples, nearest
    ordering: the JAX model (``corr_impl="matmul"``) and the port with its
    weights, each through its package's engine."""
    check_bridged_robust_mvd_engine(tmp_path, 64, 128)


def check_bridged_robust_mvd_engine(tmp_path, height, width):
    """Both engines' tables within PERF.md §2's limits, and the curves."""
    jax_model = jax_create_model("robust_mvd", pretrained=False, corr_impl="matmul")
    port_model = load_bridged(create_model("robust_mvd", device="cpu"), jax_model.variables)
    ours, ref = _run_both(tmp_path, dict(num_samples=2, num_views=3, height=height, width=width), port_model,
                          jax_model, dict(qualitatives=0, burn_in_samples=3), inputs=["poses", "intrinsics"],
                          view_ordering="nearest")
    ours, ref = without_timing(ours), without_timing(ref)
    assert list(ours.columns) == list(ref.columns)
    for column in ours.columns:
        if column[1] in ("num_views", "pred_depth_density"):
            np.testing.assert_array_equal(ours[column].to_numpy(), ref[column].to_numpy())
        elif column[1] == "inliers103":  # in percent
            assert np.abs(ours[column] - ref[column]).max() / 100 <= INLIER_FLIP_SHARE, column
        else:
            mean, mx = relative_errors(ours[column].to_numpy(np.float64), ref[column].to_numpy(np.float64))
            assert mean <= LIMITS[0] and mx <= LIMITS[1], (column, mean, mx)
    assert np.isfinite(ours.to_numpy(np.float64)).all()
    curves = [pd.read_pickle(tmp_path / label / "per_sample" / "sparsification_curves.pickle") for label in
              ("port", "jax")]
    for curve in ("pred", "oracle"):
        a, b = (c.xs(curve, level="curve").to_numpy(np.float64) for c in curves)
        mean, mx = relative_errors(a, b)
        assert mean <= LIMITS[0] and mx <= LIMITS[1], (curve, mean, mx)


@pytest.fixture
def fixture_paths(tmp_path, monkeypatch):
    """The five datasets' fixtures as the roots of the paths file of both
    packages, and the JAX resize without its native library."""
    import robustmvd_tpu.utils.native as native
    import robustmvd_tpu.utils.paths as jax_paths
    import robustmvd_tpu_torch.utils.paths as paths

    roots = write_benchmark_fixtures(tmp_path / "data", np.random.RandomState(6))
    toml = tmp_path / "rmvd_data_paths.toml"
    toml.write_text("".join(f'[{name}]\nroot = "{root}"\n' for name, root in roots.items()))
    monkeypatch.setattr(paths, "USER_PATHS_FILE", toml)
    monkeypatch.setattr(jax_paths, "USER_PATHS_FILE", toml)
    monkeypatch.setattr(native, "resize_bilinear_native", lambda img, size: None)
    return roots


def test_robustmvd_benchmark_gives_jax_table_and_files(tmp_path, fixture_paths):
    """Sample 0 of each of the five datasets (ETH3D at its benchmark size
    1024x1536, its GT at 4032x6048), nearest ordering up to 2 source views,
    no uncertainty (the sparsification of ETH3D's 24M GT pixels alone takes
    ~10 s; the engine's tests cover it)."""
    tables = {}
    for label, make in (("port", create_evaluation), ("jax", jax_create_evaluation)):
        benchmark = make("robustmvd", out_dir=str(tmp_path / label), inputs=["poses"], view_ordering="nearest",
                         max_source_views=2, eval_uncertainty=False, verbose=False)
        tables[label] = benchmark(model=DuckModel(), samples=[0], qualitatives=0)
    pd.testing.assert_frame_equal(tables["port"], tables["jax"], check_exact=True)
    assert tables["port"].shape[0] == 1 and tables["port"].columns.get_level_values("dataset").nunique() == 5
    csvs = sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*.csv"))
    assert len(csvs) == 2 + 5 * 4  # the benchmark's two, and four per dataset
    assert csvs == sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*.csv"))
    for rel in csvs:
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "jax" / rel, shallow=False), rel


def test_cli_writes_the_library_calls_results(tmp_path):
    """The CLI with robust_mvd on the CPU (synthetic's default 3 views at
    64x128, quasi-optimal ordering, 2 samples) and the same evaluation called
    as a library, with the same CPU thread count: the same results.csv
    (runtimes are NaN there: both samples are burn-in samples)."""
    env = pinned_threads_env()
    proc = subprocess.run(
        [sys.executable, "-m", "robustmvd_tpu_torch.eval", "--device", "cpu", "--eval_type", "mvd", "--dataset",
         "synthetic.train.mvd", "--model", "robust_mvd", "--inputs", "poses", "intrinsics", "--num_samples", "2",
         "--output", str(tmp_path / "cli")],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    evaluation = create_evaluation("mvd", out_dir=str(tmp_path / "lib"), inputs=["poses", "intrinsics"],
                                   verbose=False)
    evaluation(dataset=data.create_dataset("synthetic.train.mvd"), model=create_model("robust_mvd", device="cpu"),
               samples=2, qualitatives=10)
    cli_csv, lib_csv = (tmp_path / "cli" / "results.csv").read_text(), (tmp_path / "lib" / "results.csv").read_text()
    assert cli_csv == lib_csv and "absrel" in cli_csv
    assert (tmp_path / "cli" / "log.txt").stat().st_size > 0
    assert "--num_samples 2" in (tmp_path / "cli" / "cmd.txt").read_text()
    assert os.path.isfile(tmp_path / "cli" / "qualitative" / "dataset.cfg")
