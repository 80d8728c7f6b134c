#!/usr/bin/env bash
# Orchestrated benchmark wrapper (the reference benchmark.sh analog —
# which invoked a wrong module path and never ran, SURVEY.md §2.9 #18).
# Defaults follow the reference's aspirational config scaled to one host.
set -euo pipefail
VEHICLES="${1:-1000}"
TPS="${2:-200}"
DURATION="${3:-30}"
OUT="${4:-results}"
exec python -m collide.bench.run_benchmark \
  --vehicles "$VEHICLES" --tps "$TPS" --duration "$DURATION" \
  --output-dir "$OUT" --mode fast
