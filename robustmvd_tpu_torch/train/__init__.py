"""Training engines (reference: rmvd/train/__init__.py:4-12): ``mvd``,
multi-view depth training (``python -m robustmvd_tpu_torch.train``)."""

from .training import Training  # noqa: F401


def create_training(training_type, *args, **kwargs):
    if training_type == "mvd":
        from .multi_view_depth_training import MultiViewDepthTraining

        return MultiViewDepthTraining(*args, **kwargs)
    raise ValueError(f"unknown training type: {training_type}")


def list_trainings():
    return ["mvd"]
