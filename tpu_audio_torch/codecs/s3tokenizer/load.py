"""S3 tokenizer checkpoint conversion (port of
tpu_audio/codecs/s3tokenizer/load.py: convert).

The mlx-community S3TokenizerV2/V3 files are MLX module dumps: the keys
are the tree's, and the JAX rule reads every 3-D ".weight" as MLX's
(O, K, I), transposed to its (K, I, O). `convert` keeps that rule and
then takes the tree to torch's layouts (`convert.s3_params_from_numpy`), so a
3-D checkpoint weight (O, K, I) becomes (O, I, K). The CosyVoice2 loader
reads the same publisher's 3-D weights as torch's (O, I, K): the two
rules disagree, and neither is confirmed against the published files,
which are not in the repository (ROADMAP C19).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_audio_torch.convert import s3_params_from_numpy
from tpu_audio_torch.utils import pytree


def convert(flat: dict, device: torch.device | str = "cuda",
            dtype: torch.dtype = torch.float32) -> dict:
    """A flat {key: array} checkpoint → the port's tree on `device`."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if v.ndim == 3 and k.endswith(".weight"):
            v = v.transpose(1, 2, 0)  # MLX (O, K, I) → (K, I, O)
        out[k] = v
    return s3_params_from_numpy(pytree.unflatten(out), device, dtype)
