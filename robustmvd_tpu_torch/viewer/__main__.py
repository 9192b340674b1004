"""``python -m robustmvd_tpu_torch.viewer``: the dataset viewer CLI (reference:
rmvd data_viewer.py; the JAX package's root ``data_viewer.py``).

    python -m robustmvd_tpu_torch.viewer synthetic.train.mvd [--layout NAME] \\
        [--augmentations PRESET ...] [--export_dir DIR]

Shows a window where a display is available; with ``--export_dir`` (or
without a display) writes one PNG page per sample.
"""

from __future__ import annotations

import argparse
import sys

from ..data import create_dataset, list_augmentations, list_datasets
from .viewer import run_viewer
from .viewer_model import default_layout_name


def data_viewer(args):
    dataset = create_dataset(args.data, augmentations=args.augmentations)
    layout = args.layout if args.layout is not None else default_layout_name(dataset)
    return run_viewer(dataset, layout=layout, export_dir=args.export_dir)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("data", help="Data to be viewed: a path to evaluation outputs, or a dataset name. Available "
                                     f"dataset names are: {', '.join(list_datasets())}")
    parser.add_argument("--layout", help="Data viewer layout. If not specified, the default layout is used.")
    parser.add_argument("--augmentations", nargs="*",
                        help=f"Data augmentations. Options are: {', '.join(list_augmentations())}")
    parser.add_argument("--export_dir", help="Write PNG pages here instead of opening a window (the default "
                                             "where there is no display).")
    return parser.parse_args(argv)


def main(argv=None):
    data_viewer(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
