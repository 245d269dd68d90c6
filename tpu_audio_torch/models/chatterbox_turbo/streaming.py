"""Chatterbox Turbo's token-chunk streaming synthesis (port of
tpu_audio/models/chatterbox_turbo/streaming.py: TurboSynthesizer,
drop_silence).

CosyVoice2's `CV2Synthesizer` (the flow window recomputed under
chunk-causal masks, the incremental HiFT) with each window's flow solved
by the meanflow Euler steps without CFG (`model.meanflow_inference`). The
silence token is dropped from the incoming chunks, as the one-shot
`_token2wav` drops it.
"""

from __future__ import annotations

import torch

from tpu_audio_torch.codecs.s3gen import flow as s3flow
from tpu_audio_torch.codecs.s3gen import model as s3gen
from tpu_audio_torch.codecs.s3gen.noise import Noise
from tpu_audio_torch.models.chatterbox_turbo.model import SILENCE_TOKEN, meanflow_inference
from tpu_audio_torch.models.cosyvoice2.streaming import CV2Synthesizer


def meanflow_mel(params, cfg: s3gen.S3GenConfig, tokens: torch.Tensor, n: int,
                 prompt_tokens: torch.Tensor, p_len: int, prompt_mel: torch.Tensor,
                 prompt_mel_len: int, embedding: torch.Tensor, noise=None,
                 streaming: bool = False, n_timesteps: int = 2) -> torch.Tensor:
    """S3Gen's flow front (`s3gen.flow_inputs`) and the meanflow solve:
    mel (1, 2(P + T), 80), z from `noise` (by default `Noise(0)`)."""
    mu, h_len, spks, cond = s3gen.flow_inputs(params, cfg, tokens, n, prompt_tokens, p_len,
                                              prompt_mel, prompt_mel_len, embedding, streaming)
    est_p = params["flow"]["decoder_estimator"]

    def est(x, ml, mu_, t, spks_, cond_, stream, r):
        return s3flow.estimator_forward(est_p, cfg.estimator, x, ml, mu_, t, spks_, cond_,
                                        stream, r=r)

    z = (noise or Noise(0)).z(tuple(mu.shape), mu.device)
    return meanflow_inference(est, mu, h_len, spks, cond, z, n_timesteps, streaming)


class TurboSynthesizer(CV2Synthesizer):
    """`CV2Synthesizer` with the meanflow window in place of the CFG solve;
    `params` is the Turbo S3Gen tree."""

    def __init__(self, params, cfg: s3gen.S3GenConfig, n_timesteps: int = 2):
        super().__init__(params, cfg)
        self.n_timesteps = n_timesteps

    def flow_window(self, tokens, n, prompt_tokens, p_len, prompt_mel, embedding, noise,
                    streaming):
        return meanflow_mel(self.params, self.cfg, tokens, n, prompt_tokens, p_len, prompt_mel,
                            prompt_mel.shape[1], embedding, noise, streaming, self.n_timesteps)


def drop_silence(token_chunks):
    """Each incoming chunk without SILENCE_TOKEN (empty chunks dropped)."""
    for chunk in token_chunks:
        kept = [t for t in chunk if t != SILENCE_TOKEN]
        if kept:
            yield kept
