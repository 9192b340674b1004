"""robustmvd_tpu_torch — the Robust MVD framework in PyTorch, for NVIDIA Hopper.

The PyTorch and CUDA counterpart of the JAX package ``robustmvd_tpu``, built
slice by slice under the same string interfaces
(reference: rmvd/__init__.py:1-25). It covers the inference of
``robust_mvd``, ``mvsnet_train``, ``cvp_mvsnet`` and ``vis_mvsnet``
(``create_model``, ``list_models``, ``has_model``, ``model.run(...)``,
``python -m robustmvd_tpu_torch.inference``), the five Robust MVD benchmark
datasets and ``synthetic`` (``create_dataset``, ``create_dataloader``,
``list_datasets``, ...), and their evaluation (``create_evaluation("mvd" |
"robustmvd")``, ``python -m robustmvd_tpu_torch.eval``).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""

__version__ = "0.1.0"

from .data import (  # noqa: F401
    create_dataloader,
    create_dataset,
    has_dataset,
    list_base_datasets,
    list_dataset_types,
    list_datasets,
    list_splits,
)
from .eval import create_evaluation, list_evaluations  # noqa: F401
from .models import create_model, has_model, list_models, prepare_custom_model  # noqa: F401
