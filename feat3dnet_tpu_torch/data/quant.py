"""Fixed-point int16 upload of training batches (numpy copy of
feat3dnet_tpu/data/quant.py).

The host quantizes each uploaded stack of triplet batches to
q = round(x / scale) with one f32 scale per stack (max|x| / 32767), so the
host-to-device copy carries half the bytes of f32; the train step
dequantizes on its device as `q.to(float32) * scale` before augmentation
(train/trainer.py). The worst coordinate error is scale / 2, about
max|x| / 65534: under a millimetre for a 50 m cloud. The input stream is
then no longer the f32 one, so it is opt-in (cli.train --upload_quant int16).
"""
from typing import Tuple

import numpy as np

__all__ = ["quantize_clouds", "QUANT_MAX"]

QUANT_MAX = 32767.0  # int16 full scale


def quantize_clouds(stacked: np.ndarray) -> Tuple[np.ndarray, np.float32]:
    """(..., 3) f32 coordinates -> (int16 q, f32 scale) with x ~ q * scale:
    one scale per call, round to nearest even. Inputs are finite."""
    stacked = np.asarray(stacked, np.float32)
    scale = np.float32(max(float(np.abs(stacked).max()), 1e-12) / QUANT_MAX)
    q = np.round(stacked / scale).astype(np.int16)
    return q, scale
