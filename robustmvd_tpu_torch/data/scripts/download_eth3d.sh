#!/bin/bash
# Download the ETH3D high-res multi-view training data
# (reference parity: rmvd/data/scripts/download_eth3d.sh).
set -e
[ -z "$1" ] && { echo "Usage: $0 /path/to/eth3d"; exit 1; }
TARGET="$1"; mkdir -p "$TARGET"; cd "$TARGET"
categories=(courtyard delivery_area electro facade kicker meadow office pipes playground relief relief_2 terrace terrains)
datas=(dslr_jpg dslr_undistorted dslr_depth)
for category in "${categories[@]}"; do
  for data in "${datas[@]}"; do
    f=${category}_${data}.7z
    wget --no-check-certificate "https://www.eth3d.net/data/${f}"
    7z x "$f" && rm "$f"
  done
done
echo Done
