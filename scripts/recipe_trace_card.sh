#!/bin/bash
# Traces a miss of the recipe's held-out FPR@95 limit on one CUDA card, from
# the root of a checkout:
#   1. the recipe from the JAX CLI's initial weights (seed 0, exported on the
#      CPU by scripts/export_jax_train_state.py --init_seed 0 --num_clusters
#      256 --out build/jax_init_seed0.npz), autograd and --fused_towers;
#   2. seed 2 on both routes (two more draws of the port's own init);
#   3. for each of those runs, FPR@95 of every kept stage-2 checkpoint on the
#      held-out and the training places' cluster pairs;
#   4. chip_smoke's phase 24 on the committed autograd seed-0 run.
# Everything goes under OUT (default chiprun_out/trace), one log per step.
set -eo pipefail

OUT=${OUT:-chiprun_out/trace}
INIT=${INIT:-build/jax_init_seed0.npz}
mkdir -p "$OUT/logs"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/logs/card.txt"

run() {   # run <log name> <command...>: the command's output into its log, timed
    local name=$1 t0=$SECONDS rc=0; shift
    "$@" > "$OUT/logs/$name.txt" 2>&1 || rc=$?
    echo "$name: $((SECONDS - t0)) s, rc $rc"
    return $rc
}

for spec in "jaxinit_autograd:--init_variables $INIT" "jaxinit_fused:--init_variables $INIT --fused_towers" \
            "autograd_seed2:--seed 2" "fused_seed2:--seed 2 --fused_towers"; do
    name=${spec%%:*}
    run "$name" python3 -m feat3dnet_tpu_torch.examples.scaled_accuracy_run ${spec#*:} \
        --keep_dir "build/trace/$name" --results_dir "$OUT/$name" || continue
    python3 -c "import json,sys; s=json.load(open(sys.argv[1])); print(sys.argv[1], \
        json.dumps(s['limits']), s['train_s'], s['ms_per_step'], s['peak_gib'])" \
        "$OUT/$name/summary.json"
    run "${name}_by_ckpt" python3 scripts/heldout_fpr_by_checkpoint.py "build/trace/$name" ||
        true
    cat "$OUT/logs/${name}_by_ckpt.txt"
    rm -rf "build/trace/$name/train"
done
run phase24 python3 -c "
import sys, torch
import chip_smoke as cs
cs.recipe_phase(torch.device('cuda', 0), open(sys.argv[1]).read().strip())" "$OUT/logs/card.txt" ||
    tail -5 "$OUT/logs/phase24.txt"
echo "all steps ran"
