"""Imports the dataset definitions, which register themselves."""

from . import dtu, eth3d, kitti, scannet, synthetic, tanks_and_temples  # noqa: F401
