#!/usr/bin/env bash
# The port's CI legs, in the order of the JAX package's scripts/ci.sh:
# the static-analysis gate, the port's tests on the CPU, the acceptance
# smokes, the doctor over obs_smoke's files, then perf_gate in fail mode.
# Every artifact lands under results/torch/, never in results/.
#
# Usage: scripts_torch/ci.sh [DEVICE]
#   DEVICE (e.g. cpu) is given to the smokes and the doctor as their
#   --device: `scripts_torch/ci.sh cpu` runs their plain versions on the
#   CPU; without it they run on the CUDA card and exit 2 where there is
#   none. The gate and the tests are host-only.
set -o pipefail
cd "$(dirname "$0")/.."

DEV=()
if [ "$#" -gt 1 ] || [ "${1#-}" != "$1" ]; then
    echo "usage: scripts_torch/ci.sh [DEVICE]" >&2
    exit 2
elif [ -n "$1" ]; then
    DEV=(--device "$1")
fi
mkdir -p results/torch

run() {
    "$@"
    rc=$?
    if [ "$rc" -ne 0 ]; then exit "$rc"; fi
}

# Static invariant checks of the port — FIRST, because they need no
# torch and fail in seconds: lock-order/thread discipline, device-body
# purity, telemetry cross-reference, compile-ladder discipline,
# config/CLI/doc drift, guard-inference races, integer exactness and the
# int32 overflow certificate (diffed against the committed
# tuplewise_tpu_torch/analysis/exactness_bounds.toml), the request
# path's host-cost certificate (diffed against hotpath_budget.toml:
# growth fails, shrinkage ratchets the budget down), the lifecycle
# checks, import cycles. Findings are suppressible only via the
# committed tuplewise_tpu_torch/analysis/waivers.toml. The JSON report,
# its SARIF twin and the hotpath certificate land in results/torch/.
run timeout -k 10 180 python scripts_torch/analysis_gate.py \
    --sarif results/torch/analysis_report.sarif

# The port's tests on the CPU (each held against the JAX package, which
# runs there on the CPU; the tests that need the card skip), one file a
# worker process.
rm -f "${TMPDIR:-/tmp}/_torch_t1.log"
timeout -k 10 1470 env JAX_PLATFORMS=cpu \
    python -m pytest tests/test_torch_*.py -q -m 'not slow' \
    -p no:cacheprovider -p xdist -n 6 --dist loadfile -p no:randomly 2>&1 \
    | tee "${TMPDIR:-/tmp}/_torch_t1.log"
rc=${PIPESTATUS[0]}
echo DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' \
    "${TMPDIR:-/tmp}/_torch_t1.log" | tr -cd . | wc -c)
if [ "$rc" -ne 0 ]; then exit "$rc"; fi

# The acceptance smokes, with the arguments the JAX package's ci.sh
# gives its scripts (chip_smoke.py phase 30 runs the same parts).
run timeout -k 10 120 python scripts_torch/streaming_smoke.py "${DEV[@]}"
run timeout -k 10 300 python scripts_torch/streaming_smoke.py \
    --mesh-shards 2 --delta-fraction 0.25 --n-events 6000 --count-kernel \
    "${DEV[@]}"
run timeout -k 10 360 python scripts_torch/multitenant_smoke.py \
    --count-kernel "${DEV[@]}"
run timeout -k 10 300 python scripts_torch/controller_smoke.py "${DEV[@]}"
run timeout -k 10 240 python scripts_torch/chaos_smoke.py "${DEV[@]}"
run timeout -k 10 420 python scripts_torch/preemption_smoke.py "${DEV[@]}"
run timeout -k 10 240 python scripts_torch/obs_smoke.py "${DEV[@]}"
run timeout -k 10 600 python scripts_torch/mesh8_cpu.py "${DEV[@]}"

# The doctor over obs_smoke's files: the chaos run must diagnose as
# recovered (exit 0; "degraded" exits 2), every injected fault
# correlated with its recovery, the last stdout line one JSON verdict.
timeout -k 10 120 python -m tuplewise_tpu_torch.harness.cli doctor \
    --metrics results/torch/metrics.jsonl \
    --flight results/torch/obs_flight.jsonl \
    --spans results/torch/obs_spans.jsonl \
    --quiet --out results/torch/doctor_report.json "${DEV[@]}" \
    | tee results/torch/doctor_verdict.jsonl
rc=${PIPESTATUS[0]}
if [ "$rc" -ne 0 ]; then exit "$rc"; fi
run python - <<'PYEOF'
import json
with open("results/torch/doctor_verdict.jsonl") as f:
    line = f.read().strip().splitlines()[-1]
v = json.loads(line)
assert v["healthy"], v
assert v["faults"] == v["faults_resolved"] >= 4, v
print("doctor verdict OK:", v)
PYEOF

# Perf gate over the port's serving history (results/torch/serving.jsonl):
# a breach of any gated stage fails; no gateable rows pass.
timeout -k 10 60 python scripts_torch/perf_gate.py --mode fail
exit $?
