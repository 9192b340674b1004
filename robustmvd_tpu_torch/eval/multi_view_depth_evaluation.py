"""Single-dataset multi-view depth evaluation engine (reference:
rmvd/eval/multi_view_depth_evaluation.py:27-896), the JAX package's, item for
item:

- input/GT split by modality (:463-467);
- source-view orderings: "quasi-optimal" (run the model once per
  (key, source) pair and rank by absrel, :436-456) and "nearest" (by index
  distance, :429-434);
- sweep num_source_views in [min..max], keep the best-absrel result
  (:297-329);
- alignments: none / "median" / "least_squares_scale_shift" closed-form
  2x2 solve (:478-529);
- predictions resized to GT with order-0 and clipped to (0.1, 100)
  (:472-473, :531-534);
- metrics absrel x100, 1.03-inliers x100, density (:583-610);
- uncertainty: sparsification curves + AUSE on the best prediction
  (:616-655);
- pandas results with (num_views, metric) MultiIndex columns, resume-skip
  via ``.results_df.pickle`` (:197-200), csv+pickle outputs, qualitatives
  and a re-openable ``dataset.cfg`` (:657-730);
- runtimes and device memory per run, burn-in samples excluded (:549-572);
- a sample's views uploaded once to the model's device, for a model whose
  input adapter takes them there (the JAX engine's staging).

The engine is host-side numpy; the model's forward is PyTorch's, on the
device the model lives on. On the card the forward is timed with CUDA
events and the memory is PyTorch's peak allocation (see ``_run_model``).
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import time
from copy import deepcopy
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd
import torch

from ..data.layouts import EvalMVDLayout
from ..utils import get_full_class_name, logging, numpy_collate, resize_nearest, select_by_index
from ..utils.vis import vis
from .metrics import m_rel_ae, pointwise_rel_ae, sparsification, thresh_inliers


def filter_views_in_sample(sample, indices_to_keep):
    """Restrict a batched sample to a subset of views

    (reference: multi_view_depth_evaluation.py:868-882). The per-view arrays
    are selected by reference, not copied: nothing downstream mutates them,
    and staged images stay the tensors that were uploaded once per sample."""
    keyview_idx = int(np.asarray(sample["keyview_idx"]).reshape(-1)[0])
    assert keyview_idx in indices_to_keep, "Keyview must not be filtered out."
    new_key = indices_to_keep.index(keyview_idx)

    views = {
        key: sample[key]
        for key in ("images", "poses", "intrinsics")
        if key in sample and sample[key] is not None
    }
    sample = deepcopy({k: v for k, v in sample.items() if k not in views})
    for key, vals in views.items():
        sample[key] = [select_by_index(vals, i) for i in indices_to_keep]
    sample["keyview_idx"] = np.array([new_key])
    return sample


class MultiViewDepthEvaluation:
    def __init__(
        self,
        out_dir: Optional[str] = None,
        inputs: Sequence[str] = None,
        alignment: Optional[str] = None,
        max_source_views: Optional[int] = None,
        min_source_views: int = 1,
        view_ordering: str = "quasi-optimal",
        eval_uncertainty: bool = True,
        clip_pred_depth: Union[bool, Tuple[float, float]] = True,
        sparse_pred: bool = False,
        verbose: bool = True,
        **_,
    ):
        self.verbose = verbose
        self.out_dir = out_dir
        if out_dir is not None:
            self.quantitatives_dir = out_dir
            self.sample_results_dir = osp.join(out_dir, "per_sample")
            self.qualitatives_dir = osp.join(out_dir, "qualitative")
            self.results_file = osp.join(out_dir, ".results_df.pickle")
            for d in (out_dir, self.sample_results_dir, self.qualitatives_dir):
                os.makedirs(d, exist_ok=True)
        else:
            self.quantitatives_dir = None
            self.sample_results_dir = None
            self.qualitatives_dir = None
            self.results_file = None

        self.inputs = list(set((inputs or []) + ["images"])) if inputs is not None else ["images"]
        self.alignment = alignment
        self.max_source_views = max_source_views
        self.min_source_views = (
            min_source_views
            if max_source_views is None
            else min(min_source_views, max_source_views)
        )
        self.view_ordering = (
            view_ordering if (max_source_views is None or max_source_views > 0) else None
        )
        self.eval_uncertainty = eval_uncertainty
        self.clip_pred_depth = clip_pred_depth
        self.sparse_pred = sparse_pred

        self._reset()

    @property
    def name(self):
        return type(self).__name__

    def _reset(self):
        self.dataset = None
        self.model = None
        self.eval_name = None
        self.finished_iterations = None
        self.sample_indices = None
        self.qualitative_indices = None
        self.burn_in_samples = None
        self.cur_sample_num = 0
        self.cur_sample_idx = 0
        self.results = None
        self.sparsification_curves = None
        self.dataset_updates = None

    # ------------------------------------------------------------------

    def __call__(
        self,
        dataset,
        model,
        samples=None,
        qualitatives: Union[int, Sequence[int]] = 10,
        burn_in_samples: int = 3,
        eval_name: Optional[str] = None,
        finished_iterations: Optional[int] = None,
        **_,
    ):
        if self.results_file is not None and osp.exists(self.results_file):
            logging.info(f"Skipping evaluation {self.name}: already finished.")
            return pd.read_pickle(self.results_file)

        self.dataset = dataset
        self.model = model
        self.eval_name = eval_name
        self.finished_iterations = finished_iterations
        self._init_sample_indices(samples)
        self._init_qualitative_indices(qualitatives)
        self._init_results()
        self.burn_in_samples = burn_in_samples

        results = self._evaluate()
        self._output_results()
        self._reset()
        return results

    def _init_sample_indices(self, samples):
        if isinstance(samples, list):
            self.sample_indices = samples
        elif isinstance(samples, int) and samples > 0:
            step = len(self.dataset) / samples
            self.sample_indices = [int(i * step) for i in range(samples)]
        else:
            self.sample_indices = list(range(len(self.dataset)))

    def _init_qualitative_indices(self, qualitatives):
        if qualitatives is None:
            self.qualitative_indices = []
        elif isinstance(qualitatives, list):
            self.qualitative_indices = qualitatives
        elif isinstance(qualitatives, int):
            if qualitatives < 0:
                self.qualitative_indices = self.sample_indices
            else:
                n = len(self.sample_indices)
                step = n / qualitatives if qualitatives else 0
                self.qualitative_indices = list(
                    {self.sample_indices[int(i * step)] for i in range(min(qualitatives, n))}
                )

    def _init_results(self):
        results = pd.DataFrame()
        results.index.name = "sample_idx"
        results.columns.name = "metric"
        self.results = pd.concat({1: results}, axis=1, names=["num_views"])
        if self.eval_uncertainty:
            x = np.linspace(0, 0.99, 100)
            columns = pd.Index(x, name="frac_removed")
            index = pd.MultiIndex.from_tuples([], names=("sample_idx", "curve"))
            self.sparsification_curves = pd.DataFrame(columns=columns, index=index)
        self.dataset_updates = {}

    # ------------------------------------------------------------------

    def _evaluate(self):
        for sample_num, sample_idx in enumerate(self.sample_indices):
            self.cur_sample_num = sample_num
            self.cur_sample_idx = sample_idx

            sample = self.dataset[sample_idx]
            sample = numpy_collate([sample])

            if self.verbose:
                logging.info(
                    f"Processing sample {sample_num + 1} / {len(self.sample_indices)} "
                    f"(index: {sample_idx}):"
                )

            should_qualitative = (
                sample_idx in self.qualitative_indices and self.out_dir is not None
            )
            keyview_idx = int(np.asarray(sample["keyview_idx"]).reshape(-1)[0])
            sample_inputs, sample_gt = self._inputs_and_gt_from_sample(sample)
            self._stage_images(sample_inputs)

            ordered_source_indices = self._get_source_view_ordering(sample_inputs, sample_gt)
            max_source_views = (
                min(len(ordered_source_indices), self.max_source_views)
                if self.max_source_views is not None
                else len(ordered_source_indices)
            )

            best_metrics = None
            best_pred = None
            cur_sample_inputs = sample_inputs
            cur_sample_gt = sample_gt

            for num_source_views in range(self.min_source_views, max_source_views + 1):
                cur_source_indices = ordered_source_indices[:num_source_views]
                cur_view_indices = sorted([keyview_idx] + cur_source_indices)

                cur_sample_gt = deepcopy(sample_gt)
                cur_sample_inputs = filter_views_in_sample(sample_inputs, cur_view_indices)

                pred, runtimes, dev_mem = self._run_model(cur_sample_inputs)
                self._postprocess_sample_and_output(cur_sample_inputs, cur_sample_gt, pred)

                metrics = self._compute_metrics(cur_sample_inputs, cur_sample_gt, pred)
                metrics.update(runtimes)
                metrics.update(dev_mem)
                self._log_metrics(metrics, num_source_views)

                if np.isfinite(metrics["absrel"]) and (
                    best_metrics is None or metrics["absrel"] < best_metrics["absrel"]
                ):
                    best_metrics = metrics
                    best_metrics["num_views"] = num_source_views
                    best_pred = pred

            if best_metrics is None:
                # no view count produced a finite absrel
                best_metrics = {"absrel": np.nan, "num_views": np.nan}
                best_pred = pred

            if self.eval_uncertainty:
                best_metrics.update(
                    self._compute_uncertainty_metrics(cur_sample_inputs, cur_sample_gt, best_pred)
                )

            self._log_metrics(best_metrics, "best")

            if should_qualitative:
                qualitatives = self._compute_qualitatives(sample_inputs, sample_gt, best_pred)
                self._log_qualitatives(qualitatives)
                self._add_dataset_update(best_metrics)

            if self.verbose:
                logging.info(
                    f"Sample {sample_idx}: absrel={best_metrics['absrel']} "
                    f"with {best_metrics['num_views']} source views."
                )

        return self.results

    def _inputs_and_gt_from_sample(self, sample):
        is_input = lambda key: key in self.inputs or key == "keyview_idx"
        sample_inputs = {k: v for k, v in sample.items() if is_input(k)}
        sample_gt = {k: v for k, v in sample.items() if not is_input(k)}
        return sample_inputs, sample_gt

    def _stage_images(self, sample_inputs):
        """Upload the sample's views to the model's device once, where the
        model's input adapter takes them there (``supports_device_images``):
        the view ordering and the sweep run the model 2(V-1) times a sample,
        each on a subset of the same views. Other models get numpy views."""
        if getattr(self.model, "supports_device_images", False) and sample_inputs.get("images") is not None:
            device = self.model.device
            sample_inputs["images"] = [torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(device)
                                       for image in sample_inputs["images"]]

    def _get_source_view_ordering(self, sample_inputs, sample_gt):
        if self.view_ordering == "quasi-optimal":
            return self._quasi_optimal_ordering(sample_inputs, sample_gt)
        return self._nearest_ordering(sample_inputs)

    def _nearest_ordering(self, sample_inputs):
        keyview_idx = int(np.asarray(sample_inputs["keyview_idx"]).reshape(-1)[0])
        source_indices = [
            i for i in range(len(sample_inputs["images"])) if i != keyview_idx
        ]
        return sorted(source_indices, key=lambda x: np.abs(x - keyview_idx))

    def _quasi_optimal_ordering(self, sample_inputs, sample_gt):
        keyview_idx = int(np.asarray(sample_inputs["keyview_idx"]).reshape(-1)[0])
        source_indices = [
            i for i in range(len(sample_inputs["images"])) if i != keyview_idx
        ]
        scores = {}
        for source_idx in source_indices:
            cur_gt = deepcopy(sample_gt)
            cur_inputs = filter_views_in_sample(sample_inputs, [keyview_idx, source_idx])
            pred, _, _ = self._run_model(cur_inputs)
            self._postprocess_sample_and_output(cur_inputs, cur_gt, pred)
            metrics = self._compute_metrics(cur_inputs, cur_gt, pred)
            scores[source_idx] = metrics["absrel"]
        return sorted(scores, key=scores.get)

    # ------------------------------------------------------------------

    def _run_model(self, sample_inputs):
        """One model run: input adapter, forward, output adapter.

        ``runtime_model`` is the forward alone and ends before the output
        adapter, as in the reference's protocol (:549-572). On the card it is
        timed with CUDA events on the current stream, read once the end event
        has completed (the forward's kernels run asynchronously); elsewhere
        with the host clock. ``runtime_model_and_io`` is the host clock around
        the adapters and the forward. ``device_mem_peak_in_mib`` is PyTorch's
        peak allocation on the card during the run; NaN off the card. Runs of
        burn-in samples give NaN for all of them.
        """
        device = getattr(self.model, "device", None)
        on_card = isinstance(device, torch.device) and device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        start_io = time.time()
        adapted = (
            self.model.input_adapter(**sample_inputs)
            if hasattr(self.model, "input_adapter")
            else sample_inputs
        )
        with torch.inference_mode():
            if on_card:
                stream = torch.cuda.current_stream(device)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record(stream)
                output = self.model(**adapted)
                end.record(stream)
                end.synchronize()
                rt_model = start.elapsed_time(end) / 1000
            else:
                start_model = time.time()
                output = self.model(**adapted)
                rt_model = time.time() - start_model
        if hasattr(self.model, "output_adapter"):
            pred, _ = self.model.output_adapter(output)
        else:
            pred = output
        end_io = time.time()

        valid = self.cur_sample_num >= self.burn_in_samples
        rt_model = rt_model if valid else np.nan
        rt_io = end_io - start_io if valid else np.nan
        runtimes = {
            "runtime_model_in_sec": rt_model,
            "runtime_model_in_msec": 1000 * rt_model,
            "runtime_model_and_io_in_sec": rt_io,
            "runtime_model_and_io_in_msec": 1000 * rt_io,
        }
        mem_mib = int(torch.cuda.max_memory_allocated(device) / 1024 / 1024) if valid and on_card else np.nan
        return pred, runtimes, {"device_mem_peak_in_mib": mem_mib}

    def _postprocess_sample_and_output(self, sample_inputs, sample_gt, pred):
        """Resize to GT, align, clip (reference: :469-547)."""
        gt_depth = sample_gt["depth"]

        pred_depth = pred["depth"]
        pred_depth = resize_nearest(pred_depth, gt_depth.shape[-2:]).astype(np.float32)

        pred_mask = (
            pred_depth != 0 if self.sparse_pred else np.ones_like(pred_depth, dtype=bool)
        )
        gt_mask = gt_depth > 0

        if self.alignment == "median":
            mask = gt_mask & pred_mask
            with np.errstate(invalid="ignore"):
                ratio = (
                    np.median(gt_depth[mask]) / np.median(pred_depth[mask])
                    if mask.any()
                    else np.nan
                )
            if mask.any() and np.isfinite(ratio):
                pred_depth = pred_depth * ratio
            else:
                ratio = np.nan
            pred["scaling_factor"] = ratio

        elif self.alignment == "least_squares_scale_shift":
            mask = gt_mask & pred_mask
            with np.errstate(divide="ignore", invalid="ignore"):
                pred_invdepth = np.nan_to_num(1 / pred_depth, nan=0, posinf=0, neginf=0)
                gt_invdepth = np.nan_to_num(1 / gt_depth, nan=0, posinf=0, neginf=0)

            if mask.any():
                p = pred_invdepth[mask].astype(np.float64)
                g = gt_invdepth[mask].astype(np.float64)
                a_00 = np.sum(p * p)
                a_01 = np.sum(p)
                a_11 = np.sum(mask.astype(np.float64))
                b_0 = np.sum(g * p)
                b_1 = np.sum(g)
                det = a_00 * a_11 - a_01 * a_01
                if det > 0:
                    scale = np.float32((a_11 * b_0 - a_01 * b_1) / det)
                    shift = np.float32((-a_01 * b_0 + a_00 * b_1) / det)
                else:
                    scale, shift = np.nan, np.nan
            else:
                scale, shift = np.nan, np.nan

            pred_invdepth = scale * pred_invdepth + shift
            with np.errstate(divide="ignore", invalid="ignore"):
                pred_depth = np.nan_to_num(1 / pred_invdepth, nan=0, posinf=0, neginf=0)
            pred["least_squares_scale"] = scale
            pred["least_squares_shift"] = shift

        if isinstance(self.clip_pred_depth, tuple):
            pred_depth = (
                np.clip(pred_depth, self.clip_pred_depth[0], self.clip_pred_depth[1]) * pred_mask
            )
        elif self.clip_pred_depth:
            pred_depth = np.clip(pred_depth, 0.1, 100) * pred_mask

        with np.errstate(divide="ignore", invalid="ignore"):
            pred_invdepth = np.nan_to_num(1 / pred_depth, nan=0, posinf=0, neginf=0)

        if "depth_uncertainty" in pred:
            pred["depth_uncertainty"] = resize_nearest(
                pred["depth_uncertainty"], gt_depth.shape[-2:]
            ).astype(np.float32)

        pred["depth"] = pred_depth
        pred["invdepth"] = pred_invdepth

    def _compute_metrics(self, sample_inputs, sample_gt, pred):
        gt_depth = sample_gt["depth"][0, 0]
        pred_depth = pred["depth"][0, 0]
        eval_mask = (
            pred_depth != 0 if self.sparse_pred else np.ones_like(pred_depth, dtype=bool)
        )
        metrics = {
            "absrel": m_rel_ae(
                gt=gt_depth, pred=pred_depth, mask=eval_mask, output_scaling_factor=100.0
            ),
            "inliers103": thresh_inliers(
                gt=gt_depth, pred=pred_depth, thresh=1.03, mask=eval_mask,
                output_scaling_factor=100.0,
            ),
        }
        if self.alignment == "median":
            metrics["scaling_factor"] = pred["scaling_factor"]
        if self.alignment == "least_squares_scale_shift":
            metrics["least_squares_scale"] = pred["least_squares_scale"]
            metrics["least_squares_shift"] = pred["least_squares_shift"]
        metrics["pred_depth_density"] = np.sum(eval_mask) / eval_mask.size * 100
        return metrics

    def _log_metrics(self, metrics, num_source_views):
        for metric, val in metrics.items():
            self.results.loc[self.cur_sample_idx, (num_source_views, metric)] = val

    def _compute_uncertainty_metrics(self, sample_inputs, sample_gt, pred):
        gt_depth = sample_gt["depth"][0, 0]
        pred_depth = pred["depth"][0, 0]
        if "depth_uncertainty" not in pred:
            return {}
        pred_unc = pred["depth_uncertainty"][0, 0]
        pred_mask = (
            pred_depth != 0 if self.sparse_pred else np.ones_like(pred_depth, dtype=bool)
        )

        oracle_unc = pointwise_rel_ae(gt=gt_depth, pred=pred_depth, mask=pred_mask)
        x, curve_oracle = sparsification(gt_depth, pred_depth, oracle_unc, pred_mask)
        _, curve_pred = sparsification(gt_depth, pred_depth, pred_unc, pred_mask)
        errors = curve_pred - curve_oracle
        ause = np.sum(errors) / 100.0
        ause = ause if np.isfinite(ause) else np.nan

        if self.sparsification_curves is not None:
            self.sparsification_curves.loc[(self.cur_sample_idx, "oracle"), :] = curve_oracle
            self.sparsification_curves.loc[(self.cur_sample_idx, "pred"), :] = curve_pred
            self.sparsification_curves.loc[(self.cur_sample_idx, "error"), :] = errors

        return {"ause": ause}

    def _compute_qualitatives(self, sample_inputs, sample_gt, pred):
        gt_depth = sample_gt["depth"][0]
        pred_depth = pred["depth"][0]
        pred_invdepth = pred["invdepth"][0]
        pred_mask = (
            pred_depth != 0 if self.sparse_pred else np.ones_like(pred_depth, dtype=bool)
        )
        qualitatives = {
            "pointwise_absrel": pointwise_rel_ae(gt=gt_depth, pred=pred_depth, mask=pred_mask),
            "pred_depth": pred_depth,
            "pred_invdepth": pred_invdepth,
        }
        if "depth_uncertainty" in pred:
            qualitatives["pred_depth_uncertainty"] = pred["depth_uncertainty"][0]
        return qualitatives

    def _log_qualitatives(self, qualitatives):
        for name, arr in qualitatives.items():
            out_path = osp.join(self.qualitatives_dir, f"{self.cur_sample_idx:07d}-{name}")
            np.save(out_path + ".npy", arr)
            vis(arr).save(out_path + ".png")
            self._add_dataset_update({name: out_path + ".npy"})

    def _add_dataset_update(self, update_dict):
        entry = self.dataset_updates.setdefault(self.cur_sample_idx, {})
        entry.update(update_dict)

    # ------------------------------------------------------------------

    def _output_results(self):
        results_per_sample = self.results["best"]
        results = results_per_sample.mean()

        num_view_results_per_sample = self.results.drop("best", axis=1, level=0)
        num_view_results = num_view_results_per_sample.mean()

        if self.verbose:
            logging.info("Results:")
            logging.info(str(results))

        if self.out_dir is not None:
            results_per_sample.to_pickle(osp.join(self.sample_results_dir, "results.pickle"))
            results_per_sample.to_csv(osp.join(self.sample_results_dir, "results.csv"))
            results.to_pickle(osp.join(self.quantitatives_dir, "results.pickle"))
            results.to_csv(osp.join(self.quantitatives_dir, "results.csv"))

            num_view_results_per_sample.to_csv(
                osp.join(self.sample_results_dir, "num_source_view_results.csv")
            )
            num_view_results_per_sample.to_pickle(
                osp.join(self.sample_results_dir, "num_source_view_results.pickle")
            )
            num_view_results.to_csv(osp.join(self.quantitatives_dir, "num_source_view_results.csv"))
            num_view_results.to_pickle(
                osp.join(self.quantitatives_dir, "num_source_view_results.pickle")
            )

            if self.eval_uncertainty and self.sparsification_curves is not None:
                curves = self.sparsification_curves
                mean_curves = curves.groupby(level=1).mean()
                mean_curves.to_pickle(osp.join(self.quantitatives_dir, "sparsification_curves.pickle"))
                mean_curves.to_csv(osp.join(self.quantitatives_dir, "sparsification_curves.csv"))
                curves.to_pickle(osp.join(self.sample_results_dir, "sparsification_curves.pickle"))
                curves.to_csv(osp.join(self.sample_results_dir, "sparsification_curves.csv"))

            self._output_dataset_cfg()

            self.results.to_pickle(self.results_file)

    def _output_dataset_cfg(self):
        """Write updates + layout + a re-openable dataset.cfg so the viewer

        can display predictions over the dataset
        (reference: multi_view_depth_evaluation.py:712-730)."""
        model_name = getattr(self.model, "name", None)
        update_name = "_".join(
            s for s in [model_name, self.eval_name] if s is not None
        ) or "updates"
        updates_path = osp.join(self.qualitatives_dir, f"{update_name}.pickle")
        with open(updates_path, "wb") as f:
            pickle.dump(self.dataset_updates, f)

        layout_path = osp.join(self.qualitatives_dir, "layout.pickle")
        EvalMVDLayout("eval_mvd", eval_uncertainty=self.eval_uncertainty).write(layout_path)

        if hasattr(self.dataset, "write_config"):
            self.dataset.write_config(
                path=osp.join(self.qualitatives_dir, "dataset.cfg"),
                dataset_cls_name=get_full_class_name(self.dataset),
                updates=[updates_path],
                update_strict=True,
                layouts=[layout_path],
            )
