"""The data layer: datasets by registry name, samples as numpy dicts

(reference: rmvd/data/__init__.py). The five Robust MVD benchmark datasets,
the training datasets (StaticThings3D, BlendedMVS, FlyingThings3D, DTU's
and KITTI's training splits) and ``synthetic``, the augmentation and batch
augmentation presets, and the compound dataset."""

from . import augmentations, batch_augmentations, datasets  # noqa: F401  (they register themselves)
from .dataset import Dataset, Sample  # noqa: F401
from .dtu import DTURobustMVD  # noqa: F401
from .eth3d import ETH3DTrainRobustMVD  # noqa: F401
from .factory import create_compound_dataset, create_dataloader, create_dataset  # noqa: F401
from .kitti import KITTIRobustMVD  # noqa: F401
from .registry import (  # noqa: F401
    create_augmentation,
    create_batch_augmentation,
    has_augmentation,
    has_batch_augmentation,
    has_dataset,
    list_augmentations,
    list_batch_augmentations,
    list_base_datasets,
    list_datasets,
    list_dataset_types,
    list_splits,
    register_augmentation,
    register_batch_augmentation,
    register_dataset,
    register_default_dataset,
)
from .scannet import ScanNetRobustMVD  # noqa: F401
from .synthetic import SyntheticMVD  # noqa: F401
from .tanks_and_temples import TanksAndTemplesTrainRobustMVD  # noqa: F401
