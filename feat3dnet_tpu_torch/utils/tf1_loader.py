"""TF1 checkpoint → flax-layout variables mapping (the port's copy of
feat3dnet_tpu/utils/tf1_loader.py, on the tree that utils/convert.py's
`variables_from_module` / `load_variables_npz` give).

The reference ships TF1 `tf.train.Saver` checkpoints with variables named
by scope (e.g. `detection/conv0/conv2d/weights`, `.../bn/beta`,
`.../bn/moments/Squeeze/ExponentialMovingAverage`). This module maps such a
{name: ndarray} dict onto this framework's variable tree so pretrained
reference models run here directly (the parity gate of SURVEY.md §7.2).

TensorFlow itself is not available in this environment, so the loader
consumes an .npz/dict export rather than the raw ckpt file. To produce one
in any TF1/TF2 environment:

    import numpy as np, tensorflow as tf
    reader = tf.train.load_checkpoint('checkpoint.ckpt')
    arrays = {name: reader.get_tensor(name)
              for name in reader.get_variable_to_shape_map()}
    np.savez('checkpoint.npz', **arrays)

Name mapping (TF scope -> flax tree):

  detection/conv{i}/conv2d/weights   (1,1,ci,co) -> params.detection.conv{i}.conv2d.kernel (ci,co)
  detection/conv{i}/conv2d/biases               -> ...conv2d.bias
  detection/conv{i}/bn/beta                     -> ...bn.bias
  detection/conv{i}/bn/gamma                    -> ...bn.scale
  detection/conv{i}/bn/moments/Squeeze/ExponentialMovingAverage   -> batch_stats...bn.mean
  detection/conv{i}/bn/moments/Squeeze_1/ExponentialMovingAverage -> batch_stats...bn.var
  detection/conv_post_{i}/...                   -> same pattern
  detection/attention/conv2d/{weights,biases}   -> params.detection.attention.{kernel,bias}
  detection/orientation/conv2d/{weights,biases} -> params.detection.orientation.{kernel,bias}
  description/layer1/conv*/...                  -> params.description.conv*... ('layer1' dropped —
                                                   this framework has no extra nesting level)

Skipped: optimizer slots (`.../Adam`, `beta1_power`, ...), `global_step`.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_SKIP_RE = re.compile(r"(/Adam(_1)?$)|(^beta[12]_power$)|(^global_step$)")
_EMA_RE = re.compile(r"^(?P<scope>.*)/bn/moments/Squeeze(?P<var>_1)?/ExponentialMovingAverage$")


def _tree_set(tree: Dict, path: Sequence[str], value: np.ndarray, strict: bool) -> bool:
    node = tree
    for p in path[:-1]:
        if not isinstance(node, dict) or p not in node:
            if strict:
                raise KeyError(f"path {'/'.join(path)} not in variable tree (at {p!r})")
            return False
        node = node[p]
    leaf = path[-1]
    if not isinstance(node, dict) or leaf not in node:
        if strict:
            raise KeyError(f"path {'/'.join(path)} not in variable tree (at {leaf!r})")
        return False
    expected = np.shape(node[leaf])
    if tuple(expected) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'/'.join(path)}: tree {expected} vs ckpt {value.shape}")
    node[leaf] = value
    return True


def _map_name(name: str) -> Optional[Tuple[str, List[str]]]:
    """Return (collection, tree path) for a TF variable name, or None to skip."""
    if _SKIP_RE.search(name):
        return None

    m = _EMA_RE.match(name)
    if m:
        path = m.group("scope").split("/")
        stat = "var" if m.group("var") else "mean"
        path = _strip_layer1(path) + ["bn", stat]
        return "batch_stats", path

    parts = name.split("/")
    parts = _strip_layer1(parts)
    if len(parts) < 2:
        return None
    if (len(parts) >= 3 and parts[-2:] == ["conv2d", "weights"]
            and parts[-3] in ("attention", "orientation")):
        return "params", parts[:-2] + ["kernel"]
    if (len(parts) >= 3 and parts[-2:] == ["conv2d", "biases"]
            and parts[-3] in ("attention", "orientation")):
        return "params", parts[:-2] + ["bias"]
    if parts[-1] == "weights":
        return "params", parts[:-1] + ["kernel"]
    if parts[-1] == "biases":
        return "params", parts[:-1] + ["bias"]
    if parts[-1] == "beta":
        return "params", parts[:-1] + ["bias"]
    if parts[-1] == "gamma":
        return "params", parts[:-1] + ["scale"]
    return None


def _strip_layer1(parts: List[str]) -> List[str]:
    # The reference nests the descriptor under an SA-module scope 'layer1'
    # (feature_extraction_module -> pointnet_sa_module, feat3dnet.py:177-179);
    # this framework flattens it.
    return [p for p in parts if p != "layer1"]


def load_tf1_arrays(path: str) -> Dict[str, np.ndarray]:
    """Load a {tf_name: array} dict from .npz (or a raw dict passthrough)."""
    data = np.load(path)
    return {k: data[k] for k in data.files}


def restore_tf1_variables(
    variables: Dict[str, Any],
    arrays: Dict[str, np.ndarray],
    restore_exclude: Optional[Sequence[str]] = None,
    ignore_missing: bool = False,
) -> Tuple[Dict[str, Any], List[str], List[str]]:
    """Map TF1 arrays into a flax variables dict.

    Args:
      variables: {'params': ..., 'batch_stats': ...} from model.init; not
        mutated — a deep-copied tree is returned.
      arrays: {tf_var_name: ndarray}.
      restore_exclude: scope prefixes to skip (the reference's
        --restore_exclude, train.py:210-214 — e.g. ['detection'] for the
        two-stage recipe).
      ignore_missing: tolerate tree paths absent from the model (reference
        --ignore_missing_vars semantics, inverted direction: vars in ckpt
        but not in model are always tolerated by Saver var_list filtering).

    Returns:
      (new variables, restored tf names, skipped tf names)
    """
    import copy

    out = copy.deepcopy(to_numpy(variables))
    restored, skipped = [], []
    for name, value in arrays.items():
        mapping = _map_name(name)
        if mapping is None:
            skipped.append(name)
            continue
        collection, path = mapping
        if restore_exclude and any(path[0] == e or name.startswith(e + "/")
                                   for e in restore_exclude):
            skipped.append(name)
            continue
        value = np.asarray(value, np.float32)
        if path[-1] == "kernel" and value.ndim == 4:
            # 1x1 conv kernels (1, 1, ci, co) -> Dense (ci, co)
            if value.shape[0] != 1 or value.shape[1] != 1:
                raise ValueError(f"{name}: expected 1x1 conv kernel, got {value.shape}")
            value = value[0, 0]
        ok = _tree_set(out.get(collection, {}), path, value, strict=not ignore_missing)
        (restored if ok else skipped).append(name)
    return out, restored, skipped


def export_tf1_arrays(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of restore_tf1_variables: flax variables -> {tf1_name: array}.

    Emits exactly the names the reference's Saver writes (train.py:127-128
    checkpoint layout): conv+BN scopes as conv2d/{weights,biases} +
    bn/{beta,gamma} + bn/moments/Squeeze{,_1}/ExponentialMovingAverage,
    heads as {attention,orientation}/conv2d/{weights,biases}, and the
    descriptor tree nested back under 'layer1'. Dense kernels (ci, co) are
    re-expanded to 1x1 conv layout (1, 1, ci, co).

    Round-tripping export -> restore is tested to be the identity — the
    regression lock on the name mapping (tests/test_torch_tf1.py).
    """
    p = to_numpy(variables["params"])
    s = to_numpy(variables.get("batch_stats", {}))
    arrays: Dict[str, np.ndarray] = {}

    def tf_scope(top: str, name: str) -> str:
        # this framework flattens the reference's SA-module 'layer1' level
        return f"{top}/layer1/{name}" if top == "description" else f"{top}/{name}"

    for top, scopes in p.items():
        for name, node in scopes.items():
            scope = tf_scope(top, name)
            if name in ("attention", "orientation"):
                arrays[f"{scope}/conv2d/weights"] = node["kernel"][None, None]
                arrays[f"{scope}/conv2d/biases"] = node["bias"]
                continue
            arrays[f"{scope}/conv2d/weights"] = node["conv2d"]["kernel"][None, None]
            arrays[f"{scope}/conv2d/biases"] = node["conv2d"]["bias"]
            if "bn" in node:
                arrays[f"{scope}/bn/beta"] = node["bn"]["bias"]
                arrays[f"{scope}/bn/gamma"] = node["bn"]["scale"]
                stats = s[top][name]["bn"]
                arrays[f"{scope}/bn/moments/Squeeze/ExponentialMovingAverage"] = stats["mean"]
                arrays[f"{scope}/bn/moments/Squeeze_1/ExponentialMovingAverage"] = stats["var"]
    return arrays


def to_numpy(tree):
    """A nested dict of arrays or tensors as the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
