"""Chatterbox's voice encoder: a 3-layer LSTM speaker embedder over sliding
mel partials (port of tpu_audio/models/chatterbox/voice_encoder.py:
VoiceEncConfig, init_params, melspec, embed_partials, embed_utterance).

40 Slaney mels of the power spectrum (periodic Hann 400, hop 160 at
16 kHz), natural log floored at 1e-10; partials of 160 frames at a hop of
80 (a clip shorter than one partial is zero-padded to it); each partial's
last hidden state of the third LSTM layer → a 256-wide projection, ReLU,
L2 norm; the mean over partials, L2-normalised again.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.nn import layers, lstm
from tpu_audio_torch.ops import mel_filters, windows
from tpu_audio_torch.ops.stft import stft_power


@dataclass(frozen=True)
class VoiceEncConfig:
    num_mels: int = 40
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160
    ve_hidden_size: int = 256
    speaker_embed_size: int = 256
    partial_frames: int = 160
    partial_hop: int = 80


def numpy_params(rng: np.random.Generator, cfg: VoiceEncConfig) -> dict:
    """The JAX `init_params` tree as f32 numpy arrays: the LSTM weights
    uniform in ±1/√H, its biases zero."""
    init, hid = Init(rng), cfg.ve_hidden_size

    def layer(in_size):
        s = 1.0 / np.sqrt(hid)
        return {"wx": init.uniform((4 * hid, in_size), s),
                "wh": init.uniform((4 * hid, hid), s),
                "bias_ih": np.zeros(4 * hid, np.float32),
                "bias_hh": np.zeros(4 * hid, np.float32)}

    return {"lstm": {"0": layer(cfg.num_mels), "1": layer(hid), "2": layer(hid)},
            "proj": init.linear(hid, cfg.speaker_embed_size)}


def init_params(seed: int, cfg: VoiceEncConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, on the card unless `device`
    says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def melspec(audio: torch.Tensor, cfg: VoiceEncConfig) -> torch.Tensor:
    """(T,) 16 kHz → (frames, num_mels) f32 log-mel."""
    power = stft_power(audio, windows.hann(cfg.n_fft, periodic=True), cfg.n_fft, cfg.hop)
    fb = torch.as_tensor(mel_filters.slaney(cfg.sample_rate, cfg.n_fft, cfg.num_mels),
                         device=audio.device)
    return torch.log(torch.clamp(power @ fb.T, min=1e-10))


def embed_partials(params, cfg: VoiceEncConfig, mels: torch.Tensor) -> torch.Tensor:
    """(B, partial_frames, num_mels) partials → L2-normalised (B, E)."""
    h = mels
    for i in range(3):
        h = lstm.lstm(params["lstm"][str(i)], h)
    e = torch.relu(layers.linear(params["proj"], h[:, -1]))
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-8)


def partials(mel: torch.Tensor, cfg: VoiceEncConfig) -> torch.Tensor:
    """(frames, num_mels) → (N, partial_frames, num_mels): the partials at
    starts 0, partial_hop, … that fit (one, zero-padded, for a short clip)."""
    t = mel.shape[0]
    if t < cfg.partial_frames:
        mel = torch.nn.functional.pad(mel, (0, 0, 0, cfg.partial_frames - t))
        t = cfg.partial_frames
    starts = range(0, max(1, t - cfg.partial_frames + 1), cfg.partial_hop)
    return torch.stack([mel[s: s + cfg.partial_frames] for s in starts])


def embed_utterance(params, cfg: VoiceEncConfig, audio) -> torch.Tensor:
    """A 16 kHz waveform (numpy or a tensor) → the speaker embedding (E,),
    computed on the parameters' device in their dtype."""
    w = params["lstm"]["0"]["wx"]
    x = torch.as_tensor(np.asarray(audio, np.float32) if not isinstance(audio, torch.Tensor)
                        else audio, dtype=torch.float32, device=w.device)
    embs = embed_partials(params, cfg, partials(melspec(x, cfg), cfg).to(w.dtype))
    mean = embs.mean(dim=0)
    return mean / torch.clamp(torch.linalg.vector_norm(mean.float()), min=1e-8).to(mean.dtype)
