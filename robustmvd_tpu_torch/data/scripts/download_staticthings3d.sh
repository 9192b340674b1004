#!/bin/bash
# Download StaticThings3D (reference parity: rmvd/data/scripts/download_staticthings3d.sh).
set -e
[ -z "$1" ] && { echo "Usage: $0 /path/to/staticthings3d"; exit 1; }
TARGET="$1"; mkdir -p "$TARGET"; cd "$TARGET"
BASE="https://lmb.informatik.uni-freiburg.de/data/StaticThings3D"
for f in frames_cleanpass.tar frames_finalpass.tar depths.tar poses.tar intrinsics.tar; do
  wget --no-check-certificate "${BASE}/${f}"
  tar -xf "$f" && rm "$f"
done
echo Done
