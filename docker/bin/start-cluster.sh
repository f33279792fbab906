#!/usr/bin/env bash
# Bring up N server containers on one machine (parity:
# docker/bin/start-cluster.sh starting compute-node-i containers and mounting
# the Enron corpus at /root/data).
#
# Two modes:
#   default            — N INDEPENDENT servers (the reference's layout:
#                        each node owns its own index)
#   APSIM_MULTIHOST=1  — ONE coordinated cluster: every container joins a
#                        jax.distributed mesh (seed = compute-node-0, the
#                        conf/akka.conf:11-12 seed-node analog); node 0
#                        fronts the RPC service and replicates its op log,
#                        the rest replay it in collective lockstep
#                        (`apsim serve --mesh --replicate`).
#
# The store volume (APSIM_STORE, default ./store) is shared with
# start-preprocess.sh — the client's `start <table>` command bulk-loads the
# preprocessed table server-side (LoadData semantics, Client.scala:49-59).
set -euo pipefail
N="${1:-2}"
IMAGE="${APSIM_IMAGE:-apsim}"
DATA="${APSIM_DATA:-$(pwd)/data/maildir_small}"
STORE="${APSIM_STORE:-$(pwd)/store}"
mkdir -p "$STORE"
docker network create apsim-net 2>/dev/null || true
if [[ "${APSIM_MULTIHOST:-0}" == "1" ]]; then
  for i in $(seq 0 $((N - 1))); do
    port=$((2551 + i))
    docker run -d --name "compute-node-$i" --network apsim-net \
      -e "JAX_COORDINATOR_ADDRESS=compute-node-0:9876" \
      -e "JAX_NUM_PROCESSES=$N" \
      -e "JAX_PROCESS_ID=$i" \
      -p "$port:2551" \
      -v "$DATA:/root/data:ro" \
      -v "$STORE:/root/store" \
      "$IMAGE" serve --host 0.0.0.0 --port 2551 --mesh \
        --store /root/store --replicate compute-node-0:9877
    echo "compute-node-$i on :$port (cluster member $i/$N)"
  done
else
  for i in $(seq 0 $((N - 1))); do
    port=$((2551 + i))
    docker run -d --name "compute-node-$i" --network apsim-net \
      -p "$port:2551" \
      -v "$DATA:/root/data:ro" \
      -v "$STORE:/root/store" \
      "$IMAGE" serve --host 0.0.0.0 --port 2551 --store /root/store
    echo "compute-node-$i on :$port"
  done
fi
