#!/usr/bin/env bash
# Train + evaluate CCNet with the PyTorch/CUDA port (ccnet_tpu_torch) on
# every visible CUDA card: the port of run_local.sh. One process per card
# under torchrun (the port's counterpart of the JAX recipe's one process
# driving every chip); BS is the global batch, split over the cards.
#
# Usage: ./run_local_torch.sh <cityscapes_path> <model> <num_steps> <input_size> <ohem>
# e.g. : ./run_local_torch.sh /data/cityscapes ccnet 60000 769,769 1
set -euo pipefail

CS_PATH=${1:-/data/cityscapes}
MODEL=${2:-ccnet}
NUM_STEPS=${3:-60000}
INPUT_SIZE=${4:-769,769}
OHEM=${5:-1}
LR=${LR:-1e-2}
# reference run_local.sh used wd 5e-4; the published 79.7-mIoU table recipe
# (reference README.md:97, the blessed default) is wd 1e-4
WD=${WD:-1e-4}
BS=${BS:-8}
SNAPSHOT_DIR=${SNAPSHOT_DIR:-snapshots}
# one rank per visible card; with none, one rank, whose CLI then stops on the
# missing card (there is no CPU fallback)
NPROC=$(python -c "import torch; print(max(1, torch.cuda.device_count()))")

torchrun --standalone --nproc_per_node "$NPROC" -m ccnet_tpu_torch.cli.train \
  --data-dir "$CS_PATH" --model "$MODEL" --num-steps "$NUM_STEPS" \
  --input-size "$INPUT_SIZE" --ohem "$OHEM" --batch-size "$BS" \
  --learning-rate "$LR" --weight-decay "$WD" --snapshot-dir "$SNAPSHOT_DIR" \
  ${RESTORE_FROM:+--restore-from "$RESTORE_FROM"}

torchrun --standalone --nproc_per_node "$NPROC" -m ccnet_tpu_torch.cli.evaluate \
  --data-dir "$CS_PATH" --model "$MODEL" --input-size "$INPUT_SIZE" \
  --restore-from "$SNAPSHOT_DIR/CS_scenes_${NUM_STEPS}.pth" \
  --output-dir outputs
