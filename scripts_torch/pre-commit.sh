#!/usr/bin/env bash
# Fast pre-commit loop of the port's static checks: `tuplewise-torch
# check --diff HEAD` restricts findings to the files you changed plus
# everything that (transitively) imports them — the reverse-dependency
# closure from the module graph — so the loop runs in seconds instead
# of re-judging the whole port.
#
# Install as a git hook:
#   ln -sf ../../scripts_torch/pre-commit.sh .git/hooks/pre-commit
#
# The full unscoped run (waiver staleness, certificate diffs, SARIF)
# happens in CI: scripts_torch/analysis_gate.py is the first leg of
# scripts_torch/ci.sh. This hook is the tight loop, not the gate.
set -o pipefail
cd "$(dirname "$0")/.."
exec python -m tuplewise_tpu_torch.harness.cli check --diff HEAD "$@"
