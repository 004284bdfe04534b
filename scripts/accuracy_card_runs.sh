#!/bin/bash
# The port's accuracy programs on one CUDA card (feat3dnet_tpu_torch/examples/),
# from the root of a checkout:
#   1. scaled_accuracy_run at smoke size (--places 48, 1 + 4 epochs, fused);
#   2. the two-stage recipe at the JAX defaults (240 places x 4 views, 4 + 24
#      epochs = 4 480 steps), autograd and --fused_towers, seeds 0 and 1;
#   3. eval_inference_sweep on assets/ckpt4480_variables.npz, both extraction
#      routes, held to examples/results/scaled_accuracy/inference_sweep.json;
#   4. handcrafted_baseline; degraded_eval on ckpt/4480 and on the autograd
#      seed-0 weights; register_examples; synthetic_training_demo;
#   5. chip_smoke's phase 24 on the autograd seed-0 run's weights.
# Everything goes under OUT (default chiprun_out/accuracy), one log per step.
set -eo pipefail

OUT=${OUT:-chiprun_out/accuracy}
ASSET=feat3dnet_tpu_torch/assets/ckpt4480_variables.npz
RECORD=examples/results/scaled_accuracy/inference_sweep.json
mkdir -p "$OUT/logs"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/logs/card.txt"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'

run() {   # run <log name> <command...>: the command's output into its log, timed
    local name=$1 t0=$SECONDS rc=0; shift
    "$@" > "$OUT/logs/$name.txt" 2>&1 || rc=$?
    echo "$name: $((SECONDS - t0)) s, rc $rc"
    return $rc
}

run smoke python3 -m feat3dnet_tpu_torch.examples.scaled_accuracy_run --places 48 \
    --stage1_epochs 1 --stage2_epochs 4 --fused_towers --results_dir "$OUT/smoke"
for route in autograd fused; do
    for seed in 0 1; do
        flag=$([ "$route" = fused ] && echo --fused_towers || true)
        run "${route}_seed${seed}" python3 -m feat3dnet_tpu_torch.examples.scaled_accuracy_run \
            --seed "$seed" $flag --results_dir "$OUT/${route}_seed${seed}" ||
            { echo "${route}_seed${seed}: FAILED"; continue; }
        python3 -c "import json,sys; s=json.load(open(sys.argv[1])); print(sys.argv[1], \
            json.dumps(s['limits']), s['train_s'], s['ms_per_step'], s['peak_gib'])" \
            "$OUT/${route}_seed${seed}/summary.json"
    done
done
run sweep python3 -m feat3dnet_tpu_torch.examples.eval_inference_sweep --variables "$ASSET" \
    --record "$RECORD" --out "$OUT/scaled_accuracy/inference_sweep.json" || echo "sweep: FAILED"
run sweep_fused python3 -m feat3dnet_tpu_torch.examples.eval_inference_sweep \
    --variables "$ASSET" --use_fused_detector --record "$RECORD" \
    --out "$OUT/scaled_accuracy/inference_sweep_fused.json" || echo "sweep_fused: FAILED"
run baseline python3 -m feat3dnet_tpu_torch.examples.handcrafted_baseline \
    --results_dir "$OUT/scaled_accuracy"
run degraded python3 -m feat3dnet_tpu_torch.examples.degraded_eval --variables "$ASSET" \
    --results_dir "$OUT/scaled_accuracy"
run degraded_port python3 -m feat3dnet_tpu_torch.examples.degraded_eval \
    --variables "$OUT/autograd_seed0/variables.npz" --results_dir "$OUT/autograd_seed0"
run register python3 -m feat3dnet_tpu_torch.examples.register_examples --variables "$ASSET" \
    --out_dir build/register_examples
run demo python3 -m feat3dnet_tpu_torch.examples.synthetic_training_demo \
    --out "$OUT/synthetic_training_demo.json"
run phase24 python3 -c "
import sys, torch
import chip_smoke as cs
cs.RECIPE_DIR = sys.argv[1]
card = open(sys.argv[2]).read().strip()
cs.recipe_phase(torch.device('cuda', 0), card)" "$OUT/autograd_seed0" "$OUT/logs/card.txt"
echo "all steps ran"
