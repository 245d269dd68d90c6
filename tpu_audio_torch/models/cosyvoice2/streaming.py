"""CosyVoice2 token-chunk streaming: LM token chunks → incremental audio
(port of tpu_audio/models/cosyvoice2/streaming.py: CHUNK_SIZE,
CV2Synthesizer).

Each chunk of 25 speech tokens (after the 3 of the pre-lookahead) re-runs
the flow over the window of tokens so far with chunk-causal (streaming)
masks, so earlier frames stay as they were; the pass after the last
chunk drops the streaming masks, as the reference's finalize does. The
window is bounded: once it would pass `max_window_tokens` (150), the
emitted tokens retire and the last `rebase_prompt_tokens` (50) of them,
with their generated mel, become the next window's prompt, so a window
costs O(max_window) however long the stream. The HiFT vocoder advances by
`hift.vocode_window` with LOOKBACK_FRAMES of exact left context, the sine
phase and the lookback's source samples carried across windows. The
caller fades in the head of the first chunk (20 ms). `flow_window` is
the one window's flow pass, which Chatterbox Turbo's `TurboSynthesizer`
overrides with its meanflow solve.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from tpu_audio_torch.codecs.s3gen import hift
from tpu_audio_torch.codecs.s3gen import model as s3gen
from tpu_audio_torch.codecs.s3gen.noise import Noise

CHUNK_SIZE = 25  # speech tokens an emitted audio chunk (1 s at 25 Hz)


class CV2Synthesizer:
    def __init__(self, params, cfg: s3gen.S3GenConfig, max_window_tokens: int | None = 150,
                 rebase_prompt_tokens: int = 50):
        """max_window_tokens: the cap on the generated tokens of a flow
        window (None: the reference's whole prefix every chunk)."""
        self.params = params
        self.cfg = cfg
        self.max_window_tokens = max_window_tokens
        self.rebase_prompt_tokens = rebase_prompt_tokens

    def flow_window(self, tokens: torch.Tensor, n: int, prompt_tokens: torch.Tensor, p_len: int,
                    prompt_mel: torch.Tensor, embedding: torch.Tensor, noise,
                    streaming: bool) -> torch.Tensor:
        """One window's mel (1, 2(P + T), 80): the CFG flow (a subclass
        swaps the solve)."""
        return s3gen.flow_inference(self.params, self.cfg, tokens, n, prompt_tokens, p_len,
                                    prompt_mel, prompt_mel.shape[1], embedding, noise,
                                    streaming=streaming)[0]

    @torch.inference_mode()
    def stream(self, token_chunks: Iterator[list[int]], prompt_tokens: list[int],
               prompt_mel: torch.Tensor, embedding: torch.Tensor, *, seed: int = 0,
               chunk_size: int = CHUNK_SIZE, flow_noise=None,
               hift_noise=None) -> Iterator[np.ndarray]:
        """Consume the LM's token chunks, yield new audio (f32 numpy).

        prompt_tokens: the speaker's S3 tokens (the flow's scaffold);
        prompt_mel (1, 2P', 80) or (2P', 80); embedding (1, 192). The flow's
        z and HiFT's draws come from `flow_noise` / `hift_noise` (by default
        `Noise(seed)`, keyed by frame)."""
        cfg = self.cfg
        flow_noise = flow_noise or Noise(seed)
        hift_noise = hift_noise or Noise(seed)
        dev = embedding.device
        p_len0 = len(prompt_tokens)
        pm0 = prompt_mel[0] if prompt_mel.dim() == 3 else prompt_mel
        pm0 = pm0.to(device=dev, dtype=torch.float32)
        dtype = self.params["mel2wav"]["conv_pre"]["weight"].dtype
        lookahead, ratio, ups = cfg.pre_lookahead_len, cfg.token_mel_ratio, cfg.hift.upsample_scale

        gen_tokens: list[int] = []
        emitted, done = 0, False
        chunks = iter(token_chunks)
        base, cur_pt, cur_pm = 0, list(prompt_tokens), pm0
        mel_buf = torch.zeros((0, cfg.mel_dim), device=dev)
        phase = torch.zeros((1, cfg.hift.nb_harmonics + 1), dtype=torch.float64, device=dev)
        source_tail = torch.zeros((1, 0), device=dev)
        voc_frames = 0  # absolute mel frames (the prompt's included) already vocoded
        while True:
            while not done and len(gen_tokens) < emitted + chunk_size + lookahead:
                try:
                    gen_tokens.extend(next(chunks))
                except StopIteration:
                    done = True
            emit_upto = len(gen_tokens) if done else emitted + chunk_size
            if emit_upto <= emitted:
                break
            window_end = len(gen_tokens) if done else min(len(gen_tokens), emit_upto + lookahead)
            reb = self.rebase_prompt_tokens
            if (self.max_window_tokens is not None and window_end - base > self.max_window_tokens
                    and emitted - reb >= base and emitted >= reb):
                base = emitted  # retire: the emitted tail becomes the prompt scaffold
                cur_pt = gen_tokens[base - reb: base]
                cur_pm = mel_buf[(p_len0 + base - reb) * ratio: (p_len0 + base) * ratio]
            p_len, n = len(cur_pt), window_end - base
            t_pad = max(32, -(-n // 32) * 32)
            toks = torch.zeros((1, t_pad), dtype=torch.int64)
            toks[0, :n] = torch.as_tensor(gen_tokens[base:window_end])
            pt = torch.as_tensor(np.asarray(cur_pt, np.int64).reshape(1, -1), device=dev)
            mel = self.flow_window(toks.to(dev), n, pt, p_len, cur_pm[None], embedding,
                                   flow_noise, streaming=not done)[0].float()
            need = (p_len0 + window_end) * ratio
            if mel_buf.shape[0] < need:
                mel_buf = torch.cat([mel_buf, mel_buf.new_zeros((need - mel_buf.shape[0],
                                                                 cfg.mel_dim))])
            if base == 0:  # the first windows keep the prompt region's mel too
                mel_buf[: p_len0 * ratio] = mel[: p_len0 * ratio]
            mel_buf[(p_len0 + base) * ratio: need] = mel[p_len * ratio: (p_len + n) * ratio]

            valid_frames = (p_len0 + emit_upto) * ratio
            lb = min(hift.LOOKBACK_FRAMES, voc_frames)
            n_new = valid_frames - voc_frames
            window = mel_buf[voc_frames - lb: valid_frames]
            audio_w, phase, source_w = hift.vocode_window(
                self.params["mel2wav"], cfg.hift, window[None].to(dtype), hift_noise,
                phase, source_tail[:, source_tail.shape[1] - lb * ups:], voc_frames)
            new_lb = min(hift.LOOKBACK_FRAMES, valid_frames)
            source_tail = source_w[:, (lb + n_new - new_lb) * ups:]
            skip = max(0, p_len0 * ratio - voc_frames)  # the prompt region's samples
            new_audio = audio_w[0, (lb + skip) * ups:]
            voc_frames, emitted = valid_frames, emit_upto
            if new_audio.numel():
                yield new_audio.float().cpu().numpy()
            if done:
                break
