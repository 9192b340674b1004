"""The data layer: datasets by registry name, samples as numpy dicts

(reference: rmvd/data/__init__.py). The five Robust MVD benchmark datasets
and ``synthetic``; the training datasets and augmentations come with the
training slice."""

from . import datasets  # noqa: F401  (the dataset definitions register themselves)
from .dataset import Dataset, Sample  # noqa: F401
from .dtu import DTURobustMVD  # noqa: F401
from .eth3d import ETH3DTrainRobustMVD  # noqa: F401
from .factory import create_dataloader, create_dataset  # noqa: F401
from .kitti import KITTIRobustMVD  # noqa: F401
from .registry import (  # noqa: F401
    has_dataset,
    list_base_datasets,
    list_datasets,
    list_dataset_types,
    list_splits,
    register_dataset,
    register_default_dataset,
)
from .scannet import ScanNetRobustMVD  # noqa: F401
from .synthetic import SyntheticMVD  # noqa: F401
from .tanks_and_temples import TanksAndTemplesTrainRobustMVD  # noqa: F401
