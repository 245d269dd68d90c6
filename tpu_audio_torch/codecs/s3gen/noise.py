"""The random draws of S3Gen: the flow's starting noise z, and HiFT's
sine-source phase offsets and per-sample noise.

The JAX package draws them with its PRNG, which torch cannot reproduce.
`Noise(seed)` draws its own, each value a pure function of (seed, stream,
absolute position): a 32-bit counter hash (`snac.model._mix`) into
uniforms, Box–Muller for normals, identical on the CPU and the card up to
float64 rounding. HiFT's per-sample noise is keyed by the absolute mel
frame, as the JAX `_position_noise` keys it, so a window of a stream draws
what the whole pass draws there (`hift.vocode_window` against
`hift.generate`). A test hands in an object with the same three methods
that returns the JAX package's own draws.
"""

from __future__ import annotations

import math

import torch

from tpu_audio_torch.codecs.snac.model import _M32, _mix

Z, RAND_INI, FRAMES = 1, 2, 3  # the streams


def _uniform(seed: int, stream: int, row: int, idx: torch.Tensor, sub: int) -> torch.Tensor:
    key = _mix(_mix(_mix(_mix(seed & _M32) ^ stream) ^ row) ^ sub)
    h = _mix((idx & _M32) ^ key)
    return ((h >> 8).double() + 0.5) / 2.0 ** 24  # (0, 1)


def _normal(seed: int, stream: int, row: int, idx: torch.Tensor) -> torch.Tensor:
    u0, u1 = (_uniform(seed, stream, row, idx, s) for s in (0, 1))
    return (torch.sqrt(-2.0 * torch.log(u0)) * torch.cos(2.0 * math.pi * u1)).float()


class Noise:
    """Position-keyed draws from one seed."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def z(self, shape, device) -> torch.Tensor:
        """The flow's N(0, 1) start (B, T, D), keyed by (row, frame, channel)."""
        return self.z_chunk(0, shape, device)

    def z_chunk(self, start_frame: int, shape, device) -> torch.Tensor:
        """`z`'s frames start_frame .. start_frame + T − 1 (B, T, D): what the
        whole window draws there (a streamed chunk's start)."""
        b, t, d = shape
        idx = start_frame * d + torch.arange(t * d, device=device, dtype=torch.int64)
        return torch.stack([_normal(self.seed, Z, r, idx).reshape(t, d) for r in range(b)])

    def rand_ini(self, b: int, h: int, device) -> torch.Tensor:
        """HiFT's harmonic phase offsets (B, H) in [0, 1), the fundamental's 0."""
        idx = torch.arange(h, device=device, dtype=torch.int64)
        u = torch.stack([_uniform(self.seed, RAND_INI, r, idx, 0).float() for r in range(b)])
        u[:, 0] = 0.0
        return u

    def frames(self, start_frame: int, n_frames: int, b: int, per: int, h: int,
               device) -> torch.Tensor:
        """HiFT's N(0, 1) noise (B, n_frames · per, H) for the mel frames
        start_frame .. start_frame + n_frames - 1."""
        idx = start_frame * per * h + torch.arange(n_frames * per * h, device=device,
                                                   dtype=torch.int64)
        return torch.stack([_normal(self.seed, FRAMES, r, idx).reshape(n_frames * per, h)
                            for r in range(b)])
