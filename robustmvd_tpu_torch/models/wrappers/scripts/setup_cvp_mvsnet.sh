#!/bin/bash
# Clone CVP-MVSNet (weights ship in the repo) (reference parity: setup_cvp_mvsnet.sh).
set -e
TARGET=${1:-/tmp/CVP-MVSNet}
git clone https://github.com/JiayuYANG/CVP-MVSNet "$TARGET"
echo "Set [cvp_mvsnet] root = '$TARGET' in robustmvd_tpu_torch/models/wrappers/paths.toml"
