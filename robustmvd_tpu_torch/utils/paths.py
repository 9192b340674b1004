"""Dataset roots from a TOML file (reference: rmvd/data/paths.toml,
rmvd/utils/utils.py:372-388).

The roots come from ``~/rmvd_data_paths.toml`` where it exists, else from
the package's own ``data/paths.toml``.
"""

from __future__ import annotations

import os
import tomllib
from pathlib import Path

USER_PATHS_FILE = Path(os.path.expanduser("~")) / "rmvd_data_paths.toml"
PKG_PATHS_FILE = Path(__file__).resolve().parent.parent / "data" / "paths.toml"


def load_paths():
    """The paths TOML file as a nested dict; {} if there is none."""
    for cand in (USER_PATHS_FILE, PKG_PATHS_FILE):
        if cand.is_file():
            with open(cand, "rb") as f:
                return tomllib.load(f)
    return {}


def get_path(*keys):
    """Walk nested keys such as ("kitti", "root"); the str or list found at
    the last key, or None."""
    node = load_paths()
    path = None
    for idx, key in enumerate(keys):
        if key in node:
            val = node[key]
            if isinstance(val, (str, list)) and idx == len(keys) - 1:
                path = val
            elif isinstance(val, dict):
                node = val
    return path
