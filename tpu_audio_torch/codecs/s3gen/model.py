"""S3Gen: speech tokens → 24 kHz waveform (port of
tpu_audio/codecs/s3gen/model.py: S3GenConfig, init_params, flow_inference,
token2wav, fade_in, embed_ref_mel).

S3Token2Mel: the L2-normalised x-vector through an affine to the mel
width; the prompt and target tokens embedded together through the
upsampling conformer and a projection to the mel width (mu); the CFG flow
solve conditioned on the prompt's mel over the prompt frames; the prompt
frames then dropped by the caller. S3Token2Wav adds the HiFT vocoder and a
20 ms fade-in against prompt bleed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen import campplus, conformer, flow, hift
from tpu_audio_torch.codecs.s3gen.noise import Noise
from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.convert import s3_params_from_numpy
from tpu_audio_torch.nn import layers

S3GEN_SR = 24000
TOKEN_RATE = 25  # speech tokens a second
MEL_RATE = 50  # flow frames a second


@dataclass(frozen=True)
class S3GenConfig:
    vocab_size: int = 6561
    input_dim: int = 512
    spk_dim: int = 192
    mel_dim: int = 80
    conformer: conformer.ConformerConfig = field(default_factory=conformer.ConformerConfig)
    estimator: flow.EstimatorConfig = field(default_factory=flow.EstimatorConfig)
    cfm: flow.CFMConfig = field(default_factory=flow.CFMConfig)
    hift: hift.HiFTConfig = field(default_factory=hift.HiFTConfig)
    campplus: campplus.CAMPPlusConfig = field(default_factory=campplus.CAMPPlusConfig)
    pre_lookahead_len: int = 3
    token_mel_ratio: int = 2


def tp_config(cfg: S3GenConfig, tp: int) -> S3GenConfig:
    """The config a rank of `tp` serves its flow shards at
    (`parallel.shardings.local_tree` with flow_rules): the conformer's and
    the estimator's heads divided by tp."""
    if cfg.conformer.heads % tp or cfg.estimator.num_heads % tp:
        raise ValueError(f"flow heads {cfg.conformer.heads} / {cfg.estimator.num_heads} not "
                         f"divisible by tp={tp}")
    return dataclasses.replace(
        cfg, conformer=dataclasses.replace(cfg.conformer, heads=cfg.conformer.heads // tp),
        estimator=dataclasses.replace(cfg.estimator, num_heads=cfg.estimator.num_heads // tp))


def numpy_params(rng: np.random.Generator, cfg: S3GenConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts) as f32 numpy arrays."""
    init = Init(rng)
    return {"flow": {"input_embedding": init.embedding(cfg.vocab_size, cfg.input_dim),
                     "spk_embed_affine_layer": init.linear(cfg.spk_dim, cfg.mel_dim),
                     "encoder": conformer.numpy_params(rng, cfg.conformer),
                     "encoder_proj": init.linear(cfg.conformer.output_size, cfg.mel_dim),
                     "decoder_estimator": flow.numpy_estimator(rng, cfg.estimator)},
            "mel2wav": hift.numpy_params(rng, cfg.hift),
            "speaker_encoder": campplus.numpy_params(rng, cfg.campplus)}


def init_params(seed: int, cfg: S3GenConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, on the card unless `device`
    says otherwise."""
    return s3_params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def flow_inputs(params, cfg: S3GenConfig, tokens: torch.Tensor, token_len,
                prompt_tokens: torch.Tensor, prompt_len, prompt_mel: torch.Tensor,
                prompt_mel_len, embedding: torch.Tensor, streaming: bool = False):
    """What the flow's solver conditions on: (mu (1, 2(P + T), 80), its
    valid frames (1,), the speaker's affine x-vector (1, 80), the prompt
    mel scaffold cond (1, 2(P + T), 80))."""
    fp = params["flow"]
    dt = fp["input_embedding"]["weight"].dtype
    dev = tokens.device
    emb = embedding.to(dt)
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True),
                            min=1e-8).to(dt)
    spks = layers.linear(fp["spk_embed_affine_layer"], emb)
    full = torch.cat([prompt_tokens.to(dev), tokens], dim=1).clamp(0, cfg.vocab_size - 1)
    full_len = torch.tensor([int(prompt_len) + int(token_len)], device=dev)
    x = layers.embedding(fp["input_embedding"], full)
    h, h_len = conformer.forward(fp["encoder"], cfg.conformer, x, full_len, streaming=streaming)
    mu = layers.linear(fp["encoder_proj"], h)
    t2 = mu.shape[1]
    cond = torch.zeros((1, t2, cfg.mel_dim), dtype=mu.dtype, device=dev)
    n = min(prompt_mel.shape[1], t2, int(prompt_mel_len))
    cond[:, :n] = prompt_mel[:, :n].to(mu.dtype)
    return mu, h_len, spks, cond


def flow_inference(params, cfg: S3GenConfig, tokens: torch.Tensor, token_len,
                   prompt_tokens: torch.Tensor, prompt_len, prompt_mel: torch.Tensor,
                   prompt_mel_len, embedding: torch.Tensor, noise=None, streaming: bool = False,
                   n_timesteps: int | None = None):
    """tokens (1, T), prompt_tokens (1, P), prompt_mel (1, ≥ 2P?, 80),
    embedding (1, 192); the lengths ints. Returns (mel (1, 2(P + T), 80),
    (first generated frame, generated frames)). z comes from `noise`
    (a `noise.Noise`, by default seed 0)."""
    mu, h_len, spks, cond = flow_inputs(params, cfg, tokens, token_len, prompt_tokens,
                                        prompt_len, prompt_mel, prompt_mel_len, embedding,
                                        streaming)
    z = (noise or Noise(0)).z(tuple(mu.shape), mu.device)
    mel = flow.cfm_inference(params["flow"]["decoder_estimator"], cfg.estimator, cfg.cfm, mu,
                             h_len, spks, cond, z, streaming=streaming, n_timesteps=n_timesteps)
    return mel, (int(prompt_len) * cfg.token_mel_ratio, int(token_len) * cfg.token_mel_ratio)


def token2wav(params, cfg: S3GenConfig, tokens, token_len, prompt_tokens, prompt_len,
              prompt_mel, prompt_mel_len, embedding, flow_noise=None, hift_noise=None,
              streaming: bool = False, n_timesteps: int | None = None):
    """The whole S3Token2Wav pass: (audio (1, samples), first generated
    sample, generated samples)."""
    mel, (start, valid) = flow_inference(params, cfg, tokens, token_len, prompt_tokens,
                                         prompt_len, prompt_mel, prompt_mel_len, embedding,
                                         flow_noise, streaming, n_timesteps)
    audio, _ = hift.generate(params["mel2wav"], cfg.hift, mel, hift_noise or Noise(0))
    ups = cfg.hift.upsample_scale
    return audio, start * ups, valid * ups


def fade_in(audio: torch.Tensor, sr: int = S3GEN_SR) -> torch.Tensor:
    """A 20 ms raised-cosine fade-in after 20 ms of silence, against
    prompt bleed (the reference's S3Gen.swift:259-262)."""
    n_trim = sr // 50
    fade = (torch.cos(torch.linspace(torch.pi, 0.0, n_trim, device=audio.device)) + 1) / 2
    ramp = torch.cat([torch.zeros(n_trim, device=audio.device), fade,
                      torch.ones(max(0, audio.shape[-1] - 2 * n_trim), device=audio.device)])
    return audio * ramp[: audio.shape[-1]].to(audio.dtype)


def embed_ref_mel(params, cfg: S3GenConfig, ref_fbank: torch.Tensor) -> torch.Tensor:
    """The CAMPPlus x-vector (B, 192) of mean-normalised Kaldi fbank (B, T, 80)."""
    return campplus.embed(params["speaker_encoder"], cfg.campplus, ref_fbank)
