"""The repo's accuracy programs on the port (counterparts of examples/).

Each module keeps the name of its JAX counterpart in examples/ and runs
through the port's own entry points (cli.train, InferencePipeline, eval/,
cli.infer, cli.match), on `cuda` unless `--device cpu` is passed:

  scaled_accuracy_run      the two-stage recipe on 240 synthetic places,
                           then the held-out evaluation (summary.json)
  handcrafted_baseline     FPS keypoints + a 24-D handcrafted descriptor
                           through the same held-out protocol
  eval_inference_sweep     six inference settings on a variables npz
  degraded_eval            learned vs handcrafted on degraded views
  synthetic_training_demo  a short training run with its FPR@95 trajectory
  register_examples        cli.infer + cli.match on the vendored pairs

    python -m feat3dnet_tpu_torch.examples.scaled_accuracy_run --device cuda

Every default output lies under feat3dnet_tpu_torch/examples/results/.
"""
import os

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
