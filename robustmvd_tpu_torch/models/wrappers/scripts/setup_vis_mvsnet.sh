#!/bin/bash
# Clone Vis-MVSNet (weights ship in the repo) (reference parity: setup_vis_mvsnet.sh).
set -e
TARGET=${1:-/tmp/Vis-MVSNet}
git clone https://github.com/jzhangbs/Vis-MVSNet "$TARGET"
echo "Set [vis_mvsnet] root = '$TARGET' in robustmvd_tpu_torch/models/wrappers/paths.toml"
