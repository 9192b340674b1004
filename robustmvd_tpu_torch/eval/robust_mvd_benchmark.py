"""The Robust Multi-view Depth benchmark: the five-dataset zero-shot loop

(reference: rmvd/eval/robust_mvd_benchmark.py:14-247), the JAX package's. It
runs :class:`MultiViewDepthEvaluation` over kitti / dtu / scannet /
tanks_and_temples / eth3d ``.robustmvd.mvd`` with per-dataset input sizes,
concatenates the results with a dataset level and means the "best" columns.
The sample counts are the sample lists' own (KITTI 93, DTU 110, ScanNet 200,
T&T 69, ETH3D 104).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

from ..data import create_dataset
from ..utils import logging, prepend_level
from .multi_view_depth_evaluation import MultiViewDepthEvaluation


class RobustMultiViewDepthBenchmark:
    def __init__(
        self,
        out_dir: Optional[str] = None,
        inputs: Sequence[str] = None,
        alignment: Optional[str] = None,
        max_source_views: Optional[int] = None,
        min_source_views: int = 1,
        view_ordering: str = "quasi-optimal",
        eval_uncertainty: bool = True,
        sparse_pred: bool = False,
        verbose: bool = True,
        **_,
    ):
        self.verbose = verbose
        self.out_dir = out_dir
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)

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
        self.sparse_pred = sparse_pred

    @property
    def name(self):
        return type(self).__name__

    def __call__(
        self,
        model,
        eth3d_size: Optional[Tuple[int, int]] = (1024, 1536),
        kitti_size: Optional[Tuple[int, int]] = None,
        dtu_size: Optional[Tuple[int, int]] = None,
        scannet_size: Optional[Tuple[int, int]] = None,
        tanks_and_temples_size: Optional[Tuple[int, int]] = None,
        samples: Optional[Union[int, Sequence[int]]] = None,
        qualitatives: Union[int, Sequence[int]] = 2,
        eval_name: Optional[str] = None,
        finished_iterations: Optional[int] = None,
        **_,
    ):
        datasets = [
            ("kitti.robustmvd.mvd", kitti_size),
            ("dtu.robustmvd.mvd", dtu_size),
            ("scannet.robustmvd.mvd", scannet_size),
            ("tanks_and_temples.robustmvd.mvd", tanks_and_temples_size),
            ("eth3d.robustmvd.mvd", eth3d_size),
        ]

        results = []
        for dataset_name, input_size in datasets:
            logging.info(f"Running evaluation on {dataset_name}.")
            out_dir = (
                osp.join(self.out_dir, dataset_name) if self.out_dir is not None else None
            )
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)

            evaluation = MultiViewDepthEvaluation(
                out_dir=out_dir,
                inputs=self.inputs,
                alignment=self.alignment,
                view_ordering=self.view_ordering,
                max_source_views=self.max_source_views,
                min_source_views=self.min_source_views,
                eval_uncertainty=self.eval_uncertainty,
                clip_pred_depth=True,
                sparse_pred=self.sparse_pred,
                verbose=self.verbose,
            )
            dataset = create_dataset(
                dataset_name_or_path=dataset_name,
                dataset_type="mvd",
                input_size=input_size,
            )
            result = evaluation(
                dataset=dataset,
                model=model,
                samples=samples,
                qualitatives=qualitatives,
                burn_in_samples=3,
                eval_name=eval_name,
                finished_iterations=finished_iterations,
            )
            result = prepend_level(result, "dataset", dataset_name, axis=1)
            results.append(result)

        results = pd.concat(results, axis=1)
        self._output_results(results, self.out_dir)
        return results

    def _output_results(self, results, out_dir):
        num_source_view_results = results.drop("best", axis=1, level=1).mean()
        best = results.loc[:, (slice(None), "best")].droplevel(level=1, axis=1).mean()

        if self.verbose:
            logging.info("Robust MVD Benchmark Results:")
            logging.info(str(best))

        if out_dir is not None:
            best.to_csv(osp.join(out_dir, "results.csv"))
            best.to_pickle(osp.join(out_dir, "results.pickle"))
            num_source_view_results.to_csv(osp.join(out_dir, "num_source_view_results.csv"))
            num_source_view_results.to_pickle(
                osp.join(out_dir, "num_source_view_results.pickle")
            )
