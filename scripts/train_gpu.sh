#!/usr/bin/env bash
# GPU training launcher for the PyTorch port (forest_tpu_torch), the
# counterpart of scripts/train_tpu.sh: pin host BLAS threads and launch with
# auto-resume, so a preempted job continues from the last checkpoint on
# resubmit (both CLIs resume from their run directory by default). In vq
# mode, FOREST_TPU_STAGE_DIR stages the cube to fast local storage first
# (frl mode reads the cube path from the bindings YAML, so stage it
# yourself and point the bindings at the copy).
#
# NPROC (default 1) processes, one per card: above 1 the CLI runs under
# torchrun (data parallel over NCCL), at 1 it runs as a plain `python -m`.
# The repository root is put on PYTHONPATH, so the script runs from any
# directory; PYTHON (default python3) names the interpreter.
#
# Usage:
#   scripts/train_gpu.sh frl  BINDINGS.yaml TRAINING.yaml [extra args...]
#   scripts/train_gpu.sh vq   CONFIG.yaml ZARR RUN_DIR   [extra args...]
set -euo pipefail

MODE=${1:?mode: frl|vq}
shift

# Keep host-side BLAS single-threaded: the loader's decode threads own the
# cores (the reference pins torch/BLAS the same way,
# train_representation.py:61-71).
export OPENBLAS_NUM_THREADS=1 OMP_NUM_THREADS=1 MKL_NUM_THREADS=1

ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
PYTHON=${PYTHON:-python3}
NPROC=${NPROC:-1}

# Optional fast staging (vq mode): FOREST_TPU_STAGE_DIR=/dev/shm ...
# Atomic: copy to a temp dir then mv, so a preempted copy is never reused
# as a (silently truncated) cube; progress goes to stderr (stdout is the
# captured path).
stage_cube() {
  local src=$1
  if [[ -n "${FOREST_TPU_STAGE_DIR:-}" && -d "$src" ]]; then
    local dst="${FOREST_TPU_STAGE_DIR}/$(basename "$src")"
    if [[ ! -d "$dst" ]]; then
      echo "staging $src -> $dst" >&2
      local tmp="${dst}.tmp.$$"
      rm -rf "$tmp"
      cp -r "$src" "$tmp"
      mv "$tmp" "$dst"
    fi
    echo "$dst"
  else
    echo "$src"
  fi
}

# exec the CLI module: torchrun (python -m torch.distributed.run) with
# NPROC processes, or a plain python -m at one
launch() {
  local module=$1
  shift
  if [[ "$NPROC" -gt 1 ]]; then
    exec "$PYTHON" -m torch.distributed.run --standalone \
      --nproc_per_node "$NPROC" -m "$module" "$@"
  fi
  exec "$PYTHON" -m "$module" "$@"
}

case "$MODE" in
  frl)
    BINDINGS=${1:?bindings yaml}; TRAINING=${2:?training yaml}; shift 2
    launch forest_tpu_torch.training.train_representation \
      --training "$TRAINING" --bindings "$BINDINGS" "$@"
    ;;
  vq)
    CONFIG=${1:?config yaml}; ZARR=${2:?zarr path}; RUN=${3:?run dir}
    shift 3
    ZARR=$(stage_cube "$ZARR")
    launch forest_tpu_torch.training.train_vqvae \
      --config "$CONFIG" --zarr "$ZARR" --run-dir "$RUN" "$@"
    ;;
  *)
    echo "unknown mode: $MODE (frl|vq)" >&2; exit 2
    ;;
esac
