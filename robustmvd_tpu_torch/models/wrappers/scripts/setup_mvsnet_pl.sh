#!/bin/bash
# Clone the pytorch-lightning MVSNet + weights (reference parity: setup_mvsnet_pl.sh).
set -e
TARGET=${1:-/tmp/mvsnet_pl}
git clone https://github.com/kwea123/MVSNet_pl "$TARGET"
echo "Download _ckpt_epoch_14.ckpt from the MVSNet_pl release page into $TARGET"
echo "Set [mvsnet_pl] root = '$TARGET' in robustmvd_tpu_torch/models/wrappers/paths.toml"
