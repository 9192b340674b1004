"""Imports the dataset definitions, which register themselves."""

from . import (  # noqa: F401
    blendedmvs,
    dtu,
    eth3d,
    flyingthings3d,
    kitti,
    scannet,
    staticthings3d,
    synthetic,
    tanks_and_temples,
)
