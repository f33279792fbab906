#!/usr/bin/env bash
# Start/stop one apsim similarity server as a daemon.
# Parity: the reference's sbin/daemon.sh runs the assembly jar with the akka
# and app conf paths (sbin/daemon.sh:18); here the service is
# `python -m apsim.cli serve` with layered JSON configs.
#
# Usage: daemon.sh (start|stop|status) [--config conf/app.json ...] [serve args...]

set -euo pipefail

APSIM_HOME="$(cd "$(dirname "$0")/.." && pwd)"
PID_DIR="${APSIM_PID_DIR:-/tmp/apsim}"
LOG_DIR="${APSIM_LOG_DIR:-$APSIM_HOME/logs}"
PID_FILE="$PID_DIR/apsim-server.pid"
mkdir -p "$PID_DIR" "$LOG_DIR"

cmd="${1:-}"; shift || true

case "$cmd" in
  start)
    if [[ -f "$PID_FILE" ]] && kill -0 "$(cat "$PID_FILE")" 2>/dev/null; then
      echo "apsim server already running (pid $(cat "$PID_FILE"))"
      exit 0
    fi
    nohup python -m apsim.cli serve "$@" \
      > "$LOG_DIR/server.out" 2>&1 &
    echo $! > "$PID_FILE"
    echo "started apsim server pid $(cat "$PID_FILE"), log $LOG_DIR/server.out"
    ;;
  stop)
    if [[ -f "$PID_FILE" ]]; then
      kill "$(cat "$PID_FILE")" 2>/dev/null || true
      rm -f "$PID_FILE"
      echo "stopped"
    else
      echo "not running"
    fi
    ;;
  status)
    if [[ -f "$PID_FILE" ]] && kill -0 "$(cat "$PID_FILE")" 2>/dev/null; then
      echo "running (pid $(cat "$PID_FILE"))"
    else
      echo "stopped"
    fi
    ;;
  *)
    echo "usage: $0 (start|stop|status) [serve args...]" >&2
    exit 1
    ;;
esac
