#!/bin/bash
# ViT-vs-CNN separation experiment on the hard synthetic benchmark
# (dataset: examples/make_synthetic_dataset.py --hard — ray-shadow
# occlusion, unannotated clutter, curved corridors, 15% train label noise).
# Both families train with the SAME reference regime (inverse-frequency
# intent weights, no downsampling — docs/TRAINING.md round-3 regime) and
# eval with the same CLI on the same clean val split.
#
# Usage: tools/hard_bench.sh [DATA_ROOT] [STEPS] [OUT_ROOT]
set -e
DATA=${1:-/data/synthhard}
STEPS=${2:-2200}
OUT=${3:-runs_hard}
cd "$(dirname "$0")/.."

for model in vit cnn; do
  echo "=== training $model ($STEPS steps) ==="
  intentbev-train --out_dir "$OUT/$model" --max_steps "$STEPS" \
    --data_dir "$DATA/train" --model $model \
    --epochs 200 --num_workers 4 --max_points_per_sweep 30720 \
    --use_intention_weights --no_intention_downsampling
  echo "=== eval $model ==="
  python -m intentbev.evaluate \
    --ckpt_dir "$OUT/$model" --data_dir "$DATA/val" \
    2>&1 | tee "$OUT/$model/eval_val.txt" | tail -25
done
echo "HARD BENCH DONE"
