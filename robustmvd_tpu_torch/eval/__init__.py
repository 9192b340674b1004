"""Evaluations (reference: rmvd/eval/__init__.py:1-13): ``mvd``, one dataset,

and ``robustmvd``, the five-dataset Robust MVD benchmark."""


def create_evaluation(evaluation_type, *args, **kwargs):
    if evaluation_type == "mvd":
        from .multi_view_depth_evaluation import MultiViewDepthEvaluation

        return MultiViewDepthEvaluation(*args, **kwargs)
    if evaluation_type == "robustmvd":
        from .robust_mvd_benchmark import RobustMultiViewDepthBenchmark

        return RobustMultiViewDepthBenchmark(*args, **kwargs)
    raise ValueError(f"unknown evaluation type: {evaluation_type}")


def list_evaluations():
    return ["mvd", "robustmvd"]
