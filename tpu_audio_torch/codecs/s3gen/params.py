"""Random parameter trees of the S3 family (S3 tokenizer, S3Gen,
CAMPPlus) in the JAX package's layouts (`Init`);
`convert.s3_params_from_numpy` takes them, or a converted checkpoint, to
the port's layouts.
"""

from __future__ import annotations

import math

import numpy as np


class Init:
    """Random leaves from `rng` with the JAX initialisers' shapes and
    ranges (`tpu_audio/nn/layers.py`), as f32 numpy arrays."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def uniform(self, shape, scale) -> np.ndarray:
        return (self.rng.random(shape, dtype=np.float32) * 2 - 1) * np.float32(scale)

    def linear(self, i: int, o: int, bias: bool = True) -> dict:
        scale = 1.0 / math.sqrt(i)
        p = {"weight": self.uniform((o, i), scale)}
        if bias:
            p["bias"] = self.uniform((o,), scale)
        return p

    def conv(self, i: int, o: int, k: int, bias: bool = True) -> dict:
        scale = 1.0 / math.sqrt(i * k)
        p = {"weight": self.uniform((k, i, o), scale)}
        if bias:
            p["bias"] = self.uniform((o,), scale)
        return p

    def embedding(self, n: int, d: int) -> dict:
        return {"weight": self.rng.standard_normal((n, d), dtype=np.float32) * np.float32(0.02)}

    @staticmethod
    def norm(d: int) -> dict:
        return {"weight": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}
