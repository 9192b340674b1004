#!/bin/bash
# Download the Tanks and Temples robustmvd evaluation data
# (reference parity: rmvd/data/scripts/download_tanks_and_temples.sh):
# images + COLMAP reconstructions for the training scenes used by the
# benchmark split.
set -e
[ -z "$1" ] && { echo "Usage: $0 /path/to/tanks_and_temples"; exit 1; }
TARGET="$1"; mkdir -p "$TARGET"; cd "$TARGET"
echo "Tanks and Temples requires registration at https://www.tanksandtemples.org/download/."
echo "Download the 'training data' image sets and depth npz archives into $TARGET,"
echo "one directory per scene (Barn, Caterpillar, Church, Courthouse, Ignatius, Meetingroom, Truck)."
