#!/usr/bin/env bash
# Run the insert->first-result latency benchmark against a running server
# (parity: sbin/start-test.sh launching LoadGenerator).
set -euo pipefail
REMOTE="${1:-127.0.0.1:2551}"
shift || true
exec python -m apsim.cli bench --remote "$REMOTE" "$@"
