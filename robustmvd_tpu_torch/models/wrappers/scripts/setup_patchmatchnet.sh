#!/bin/bash
# Clone PatchmatchNet (weights ship in the repo) (reference parity: setup_patchmatchnet.sh).
set -e
TARGET=${1:-/tmp/patchmatchnet}
git clone https://github.com/FangjinhuaWang/PatchmatchNet "$TARGET"
echo "Set [patchmatchnet] root = '$TARGET' in robustmvd_tpu_torch/models/wrappers/paths.toml"
