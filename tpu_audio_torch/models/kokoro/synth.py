"""Kokoro synthesis in two stages at fixed shapes (port of
tpu_audio/models/kokoro/synth.py: TOKEN_PAD, FRAME_BUCKET,
KokoroSynthesizer).

Stage 1, the token axis padded to TOKEN_PAD = 512 (the model's 510-token
context and two boundary ids): ALBERT → the duration encoder → durations,
and the text encoder. The durations cross to the host once, to pick the
frame bucket (a multiple of FRAME_BUCKET = 240 frames, 6 s). Stage 2, the
frame axis padded to the bucket: the alignment products → prosody → the
decoder → the generator. The shapes are those of the JAX stages, so the
masked norms and BiLSTMs see what they see there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_audio_torch.convert import tree_device
from tpu_audio_torch.models.kokoro import model as kmodel
from tpu_audio_torch.models.kokoro.config import KokoroConfig

TOKEN_PAD = 512
FRAME_BUCKET = 240  # 6 s of 40 fps duration frames per bucket step


@dataclass
class Sentence:
    """One sentence through both stages: the padded inputs, the stage
    outputs on the device and the audio."""

    tokens: torch.Tensor  # (1, TOKEN_PAD) ids, [0] + ids + [0] then 0s
    n_tokens: torch.Tensor  # 0-d: the valid ids, boundaries included
    style_sd: torch.Tensor  # (1, style) the predictor's style
    style_dec: torch.Tensor  # (1, style) the decoder's style
    d: torch.Tensor | None = None  # (1, TOKEN_PAD, d_model + style)
    durations: torch.Tensor | None = None  # (1, TOKEN_PAD) frames a token
    t_en: torch.Tensor | None = None  # (1, TOKEN_PAD, d_model)
    total: int = 0  # frames
    frames_pad: int = 0  # the bucket
    f0: torch.Tensor | None = None  # (1, 2·frames_pad)
    n: torch.Tensor | None = None  # (1, 2·frames_pad)
    har: torch.Tensor | None = None  # (1, stft frames, n_fft + 2) the source spectrum
    audio: torch.Tensor | None = None  # (samples,) the valid samples


class KokoroSynthesizer:
    """Phoneme ids and a voice pack → 24 kHz audio, on the device and in
    the dtype of `params` (f32 served; f64 for a reference)."""

    def __init__(self, params, cfg: KokoroConfig | None = None):
        self.params = params
        self.cfg = cfg or KokoroConfig()
        self.device = tree_device(params)
        self.dtype = params["bert_encoder"]["weight"].dtype

    def prepare(self, token_ids: list[int], voice_style: np.ndarray) -> Sentence:
        """The padded ids and the two styles. voice_style: a (510, 1, 256)
        pack indexed by the phoneme count; the first style_dim channels
        condition the decoder, the next style_dim the predictor."""
        cfg = self.cfg
        ids = [0] + list(token_ids[: cfg.max_tokens]) + [0]
        tokens = torch.zeros((1, TOKEN_PAD), dtype=torch.long)
        tokens[0, : len(ids)] = torch.as_tensor(ids)
        sd = cfg.style_dim
        ref_s = np.asarray(voice_style)[min(len(token_ids) - 1, voice_style.shape[0] - 1)]

        def style(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device).to(self.dtype)
        return Sentence(tokens.to(self.device), torch.tensor(len(ids), device=self.device),
                        style(ref_s[:, sd: 2 * sd]), style(ref_s[:, :sd]))

    def stage1(self, s: Sentence, speed: float = 1.0) -> Sentence:
        """ALBERT → durations, and the text encoder; the durations' total
        read on the host, the frame bucket picked."""
        p, cfg = self.params, self.cfg
        d_en = kmodel.bert_duration_features(p, cfg, s.tokens, s.n_tokens)
        s.d = kmodel.duration_encode(p, cfg, d_en, s.style_sd, s.n_tokens)
        s.durations = kmodel.predict_durations(p, cfg, s.d, s.n_tokens, speed)
        s.t_en = kmodel.text_encode(p, cfg, s.tokens, s.n_tokens)
        s.total = int(s.durations.sum())
        s.frames_pad = max(FRAME_BUCKET, -(-s.total // FRAME_BUCKET) * FRAME_BUCKET)
        return s

    def stage2(self, s: Sentence, rng: torch.Generator | None = None, *,
               draws: tuple | None = None, har: torch.Tensor | None = None) -> Sentence:
        """The alignment products → F0 and N → the source spectrum (drawn
        from `rng`, or from injected `draws` = (rand_ini, noise), or the
        injected `har` itself) → the decoder and generator."""
        p, cfg = self.params, self.cfg
        total = torch.tensor(s.total, device=self.device)
        align = kmodel.alignment_matrix(s.durations, s.frames_pad, s.d.dtype)  # (T, F)
        en = torch.matmul(align.T, s.d)
        s.f0, s.n, _ = kmodel.f0n_predict(p, cfg, en, s.style_sd, total)
        asr = torch.matmul(align.T, s.t_en)
        if har is None:
            rand_ini, noise = (None, None) if draws is None else (
                torch.as_tensor(a, device=self.device) for a in draws)
            har = kmodel.source_spectrum(p, cfg, s.f0, rng, rand_ini, noise)
        s.har = har
        audio = kmodel.decode(p, cfg, asr, s.f0, s.n, s.style_dec, total, har)
        s.audio = audio[0, : s.total * cfg.samples_per_frame]
        return s

    def run(self, token_ids: list[int], voice_style: np.ndarray, speed: float = 1.0,
            seed: int = 0, *, draws: tuple | None = None,
            har: torch.Tensor | None = None) -> Sentence:
        """Both stages of one sentence; the sine source draws from a
        `torch.Generator` seeded with `seed` unless `draws` or `har` is
        given."""
        s = self.stage1(self.prepare(token_ids, voice_style), speed)
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return self.stage2(s, rng, draws=draws, har=har)

    def synthesize(self, token_ids: list[int], voice_style: np.ndarray, speed: float = 1.0,
                   seed: int = 0, *, draws: tuple | None = None,
                   har: torch.Tensor | None = None) -> np.ndarray:
        """token_ids: phoneme ids (≤ 510). Returns float32 audio at 24 kHz,
        `samples_per_frame` samples a duration frame."""
        s = self.run(token_ids, voice_style, speed, seed, draws=draws, har=har)
        return s.audio.float().cpu().numpy()
