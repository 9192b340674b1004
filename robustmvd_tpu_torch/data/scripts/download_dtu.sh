#!/bin/bash
# Download the DTU MVS dataset (reference parity: rmvd/data/scripts/download_dtu.sh).
set -e
[ -z "$1" ] && { echo "Usage: $0 /path/to/dtu_raw"; exit 1; }
TARGET="$1"; mkdir -p "$TARGET"; cd "$TARGET"
wget http://roboimagedata2.compute.dtu.dk/data/MVS/Rectified.zip
wget http://roboimagedata2.compute.dtu.dk/data/MVS/Points.zip
unzip Rectified.zip && rm Rectified.zip
unzip Points.zip && rm Points.zip
echo "Also obtain the Depths_raw archive (see the MVSNet project) into $TARGET/dtu/."
echo "Then run: python -m robustmvd_tpu.data.scripts.convert_dtu $TARGET /data/dtu"
