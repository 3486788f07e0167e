#!/usr/bin/env bash
# CI lane of the PyTorch/CUDA port (src/repro_torch), runnable from a fresh
# checkout on a CPU machine:
#   scripts/ci_port.sh            # the port's tests, on the CPU
#
# The port's tests import both packages and hold the port against the JAX
# package on the same inputs. Tests that need the card (tests/test_torch_cuda.py,
# marked `cuda`) skip here; on a machine with the card run
#   python -m pytest -m cuda tests/test_torch_cuda.py
# and the end-to-end check `python3 chip_smoke.py`.
set -euo pipefail
cd "$(dirname "$0")/.."
PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} JAX_PLATFORMS=cpu \
  python -m pytest -q tests/test_torch_*.py "$@"
