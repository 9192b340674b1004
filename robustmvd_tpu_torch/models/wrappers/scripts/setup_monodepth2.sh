#!/bin/bash
# Clone monodepth2 + fetch weights (reference parity: setup_monodepth2.sh).
set -e
TARGET=${1:-/tmp/monodepth2}
git clone https://github.com/nianticlabs/monodepth2 "$TARGET"
mkdir -p "$TARGET/models"
for m in mono+stereo_1024x320 mono+stereo_640x192; do
  wget -P "$TARGET/models" "https://storage.googleapis.com/niantic-lon-static/research/monodepth2/${m}.zip"
  unzip "$TARGET/models/${m}.zip" -d "$TARGET/models/${m}" && rm "$TARGET/models/${m}.zip"
done
echo "Set [monodepth2] root = '$TARGET' in robustmvd_tpu_torch/models/wrappers/paths.toml"
