"""The data layer: datasets by registry name, samples as numpy dicts

(reference: rmvd/data/__init__.py). The five Robust MVD benchmark datasets,
the training datasets (StaticThings3D, BlendedMVS, FlyingThings3D, DTU's
and KITTI's training splits) and ``synthetic``, the augmentation and batch
augmentation presets, and the compound dataset."""

from . import augmentations, batch_augmentations, datasets  # noqa: F401  (they register themselves)
from .augmentations import (  # noqa: F401
    dpt_augmentations,
    mvsnet_augmentations,
    mvsnet_sai_augmentations,
    robust_mvd_augmentations_blendedmvs,
    robust_mvd_augmentations_staticthings3d,
    supervised_monodepth2_augmentations,
)
from .batch_augmentations import robust_mvd_batch_augmentations  # noqa: F401
from .blendedmvs import BlendedMVSMVSNetTrain, BlendedMVSSeq4TrainSmall  # noqa: F401
from .dataset import Dataset, Sample  # noqa: F401
from .dtu import DTUMvsnetTrain, DTURobustMVD  # noqa: F401
from .eth3d import ETH3DTrainRobustMVD  # noqa: F401
from .factory import create_compound_dataset, create_dataloader, create_dataset  # noqa: F401
from .flyingthings3d import FlyingThings3DSeq4Train  # noqa: F401
from .kitti import KITTIEigenDenseDepthTest, KITTIEigenDenseDepthTrain, KITTIRobustMVD  # noqa: F401
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
from .staticthings3d import StaticThings3DSeq4Train  # noqa: F401
from .synthetic import SyntheticMVD  # noqa: F401
from .tanks_and_temples import TanksAndTemplesTrainRobustMVD  # noqa: F401
