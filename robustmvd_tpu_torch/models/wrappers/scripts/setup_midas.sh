#!/bin/bash
# Clone MiDaS + fetch v2.1 weights (reference parity: setup_midas.sh).
set -e
TARGET=${1:-/tmp/midas}
git clone https://github.com/isl-org/MiDaS "$TARGET"
mkdir -p "$TARGET/weights"
wget -P "$TARGET/weights" https://github.com/isl-org/MiDaS/releases/download/v2_1/midas_v21-f6b98070.pt
echo "Set [midas] root = '$TARGET' in robustmvd_tpu_torch/models/wrappers/paths.toml"
