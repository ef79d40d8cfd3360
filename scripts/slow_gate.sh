#!/usr/bin/env bash
# Recorded gate for the SLOW test suite (ED-physics oracles + example e2e
# runs — the strongest correctness statements in the repo, deselected from the
# default fast gate). Run at HEAD; it prints a stamp with the commit, wall
# time and exit status.
#
# Usage: bash scripts/slow_gate.sh  [extra pytest args...]
set -u
cd "$(dirname "$0")/.."
HEAD=$(git rev-parse --short HEAD)
START=$(date -u +"%Y-%m-%dT%H:%M:%SZ")
T0=$SECONDS
python -m pytest tests/ -q -m slow "$@" 2>&1 | tail -20
STATUS=${PIPESTATUS[0]}
ELAPSED=$((SECONDS - T0))
echo
echo "slow-gate stamp: HEAD=${HEAD} start=${START} wall=${ELAPSED}s exit=${STATUS}"
exit "$STATUS"
