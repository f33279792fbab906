#!/usr/bin/env bash
# ETL container: raw corpus -> TF-IDF vectors -> shared vector store
# (parity: docker/bin/start-preprocess.sh — the reference launches a Spark
# container over the mounted Enron corpus; here one `apsim etl` run writes
# the table + its _MAX statistic into a store volume the cluster mounts).
#
# Usage: start-preprocess.sh [table]
#   APSIM_IMAGE  image name          (default apsim)
#   APSIM_DATA   host corpus dir     (default ./data/maildir_small)
#   APSIM_STORE  host store dir      (default ./store — shared with
#                                     start-cluster.sh / start-client.sh)
set -euo pipefail
TABLE="${1:-SMALL_DATA}"
IMAGE="${APSIM_IMAGE:-apsim}"
DATA="${APSIM_DATA:-$(pwd)/data/maildir_small}"
STORE="${APSIM_STORE:-$(pwd)/store}"
mkdir -p "$STORE"
docker run --rm --name apsim-preprocess \
  -v "$DATA:/root/data:ro" \
  -v "$STORE:/root/store" \
  "$IMAGE" etl /root/data --store /root/store --table "$TABLE"
echo "preprocess done: table $TABLE in $STORE"
