"""Chatterbox Turbo engine: the GPT-2 T3 without CFG, perceiver or emotion,
and S3Gen with the meanflow few-step flow (port of
tpu_audio/models/chatterbox_turbo/engine.py: ChatterboxTurboEngine).

The speaker, the S3 tokenizer, CAMPPlus, the voice encoder and HiFT are
Chatterbox's (`ChatterboxEngine`). `_token2wav` drops the silence token
(4299), pads to a multiple of 25 and solves the flow in
`meanflow_steps` (2) Euler steps without CFG. TOKEN granularity (the
default of `generate_streaming`): the chunked T3 streamer (its first chunk
3 tokens longer, the flow's pre-lookahead) → `TurboSynthesizer`'s flow
window → the windowed HiFT, the first chunk of each sentence faded in,
each chunk handed out one behind so that the last is marked final;
SENTENCE (what `generate` takes): one T3 decode and one flow pass a
sentence.

`load()` reads mlx-community/Chatterbox-TTS-Turbo-{fp16,8bit,4bit}
(`load.py`) onto `device` (the card unless the caller asks for the CPU).
`from_turbo_params` takes built trees; its T3 cache is sized for each
request (the JAX engine's `max_cache=512` clamps, ROADMAP C22).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from tpu_audio_torch.api.tts import AudioChunk, StreamingGranularity
from tpu_audio_torch.codecs.s3gen import hift
from tpu_audio_torch.codecs.s3gen import model as s3gen
from tpu_audio_torch.convert import tree_device
from tpu_audio_torch.models.chatterbox.engine import (TOKEN_BUCKET, ChatterboxConditionals,
                                                      ChatterboxEngine, punc_norm)
from tpu_audio_torch.models.chatterbox_turbo import model as turbo
from tpu_audio_torch.models.chatterbox_turbo import streaming
from tpu_audio_torch.utils import text as textutils
from tpu_audio_torch.utils.tokenizer import load_tokenizer


class ChatterboxTurboEngine(ChatterboxEngine):
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,
                                         StreamingGranularity.TOKEN)
    default_streaming_granularity = StreamingGranularity.TOKEN

    def __init__(self, temperature: float = 0.8, top_p: float = 0.95, min_p: float = 0.05,
                 repetition_penalty: float = 1.2, meanflow_steps: int = 2,
                 variant: str = "fp16", device: torch.device | str = "cuda"):
        super().__init__(temperature=temperature, top_p=top_p, min_p=min_p,
                         repetition_penalty=repetition_penalty, cfg_weight=0.0,
                         variant=variant, device=device)
        self.meanflow_steps = meanflow_steps
        self.turbo_cfg = turbo.T3TurboConfig()
        self.turbo_gen: turbo.T3TurboGenerator | None = None
        self._t3_streamer: turbo.T3TurboStreamer | None = None
        self._turbo_synth: streaming.TurboSynthesizer | None = None

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.chatterbox_turbo import load as tload

        (t3_params, self.turbo_cfg, self.s3gen_params, self.s3gen_cfg, self.tok_params,
         self.tok_cfg, self.ve_params, self.ve_cfg,
         self.tokenizer) = tload.load(self.variant, device=self.device)
        self.turbo_gen = turbo.T3TurboGenerator(t3_params, self.turbo_cfg)
        self.is_loaded = True

    @classmethod
    def from_turbo_params(cls, t3_params, t3_cfg, s3gen_params, s3gen_cfg, tok_params,
                          tok_cfg, ve_params, ve_cfg, tokenizer=None,
                          max_cache: int | None = None) -> "ChatterboxTurboEngine":
        """An engine over built trees (the GPT-2 T3 fp or group-affine, the
        meanflow S3Gen) on their device; the T3 cache holds `max_cache`
        slots, or with None (the default) as many as each request needs."""
        eng = cls(device=tree_device(s3gen_params))
        eng.turbo_cfg = t3_cfg
        eng.turbo_gen = turbo.T3TurboGenerator(t3_params, t3_cfg, max_cache=max_cache)
        eng.s3gen_params, eng.s3gen_cfg = s3gen_params, s3gen_cfg
        eng.tok_params, eng.tok_cfg = tok_params, tok_cfg
        eng.ve_params, eng.ve_cfg = ve_params, ve_cfg
        eng.tokenizer = tokenizer or load_tokenizer(None)
        eng.is_loaded = True
        return eng

    def _default_conditionals(self) -> ChatterboxConditionals:
        cond = super()._default_conditionals()
        cond.speaker_emb = torch.zeros((1, self.turbo_cfg.speaker_embed_size),
                                       device=self._dev())
        return cond

    @torch.inference_mode()
    def _token2wav(self, speech_tokens, cond: ChatterboxConditionals, seed: int) -> np.ndarray:
        """The meanflow S3Gen pass (no CFG) + HiFT over the tokens without
        the silence token, padded to a multiple of 25, cut and faded in."""
        tokens = [t for t in speech_tokens if t != turbo.SILENCE_TOKEN]
        n = len(tokens)
        if n == 0:
            return np.zeros(0, np.float32)
        dev, cfg = self._dev(), self.s3gen_cfg
        bucket = -(-n // TOKEN_BUCKET) * TOKEN_BUCKET
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n] = torch.as_tensor(tokens, dtype=torch.int64)
        pt = cond.prompt_tokens
        flow_noise, hift_noise = self.noises(seed)
        mel = streaming.meanflow_mel(self.s3gen_params, cfg, toks.to(dev), n, pt, pt.shape[1],
                                     cond.prompt_mel, cond.prompt_mel.shape[1], cond.embedding,
                                     flow_noise, n_timesteps=self.meanflow_steps)
        audio, _ = hift.generate(self.s3gen_params["mel2wav"], cfg.hift, mel, hift_noise)
        ups = cfg.token_mel_ratio * cfg.hift.upsample_scale
        start, valid = pt.shape[1] * ups, n * ups
        return s3gen.fade_in(audio[0, start: start + valid].float()).cpu().numpy()

    def generate(self, text: str, **kw):
        """The whole text, sentence by sentence (one flow pass each)."""
        kw.setdefault("granularity", StreamingGranularity.SENTENCE)
        return super().generate(text, **kw)

    def text_ids(self, sentence: str) -> list[int]:
        """The BPE ids of the normalised sentence, clamped to the vocabulary."""
        top = self.turbo_cfg.text_tokens_dict_size - 1
        return [min(i, top) for i in self.tokenizer.encode(punc_norm(sentence))]

    def turbo_sampler(self) -> turbo.TurboSampler:
        return turbo.TurboSampler(temperature=self.temperature, top_p=self.top_p,
                                  min_p=self.min_p, repetition_penalty=self.repetition_penalty)

    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           max_new_tokens: int = 600, **kw) -> Iterator[AudioChunk]:
        if self.turbo_gen is None:
            self.load()
        cond = self.conditionals or self._default_conditionals()
        sampler = self.turbo_sampler()
        sentences = textutils.split_into_sentences(text)
        if (granularity or self.default_streaming_granularity) == StreamingGranularity.TOKEN:
            yield from self._stream_tokens(sentences, cond, sampler, max_new_tokens)
            return
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            speech = self.turbo_gen.generate(cond.speaker_emb, self.text_ids(sentence),
                                             sampler=sampler, max_new=max_new_tokens, seed=si)
            audio = self._token2wav(speech, cond, si)
            yield AudioChunk(samples=audio, sample_rate=self.sample_rate, text=sentence,
                             is_final=si == len(sentences) - 1)

    def streamer(self) -> turbo.T3TurboStreamer:
        if self._t3_streamer is None:
            self._t3_streamer = turbo.T3TurboStreamer(
                self.turbo_gen, first_extra=self.s3gen_cfg.pre_lookahead_len)
        return self._t3_streamer

    def synthesizer(self) -> streaming.TurboSynthesizer:
        if self._turbo_synth is None:
            self._turbo_synth = streaming.TurboSynthesizer(self.s3gen_params, self.s3gen_cfg,
                                                           n_timesteps=self.meanflow_steps)
        return self._turbo_synth

    def _stream_tokens(self, sentences: list[str], cond: ChatterboxConditionals,
                       sampler: turbo.TurboSampler, max_new_tokens: int) -> Iterator[AudioChunk]:
        """T3 chunks → the flow window → the windowed vocoder: the first
        audio after ~25 tokens instead of the whole first sentence."""
        streamer, synth = self.streamer(), self.synthesizer()
        prompt_tokens = cond.prompt_tokens[0].tolist()
        pending: AudioChunk | None = None
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            tokens = streaming.drop_silence(streamer.stream(
                cond.speaker_emb, self.text_ids(sentence), sampler=sampler,
                max_new=max_new_tokens, seed=si))
            flow_noise, hift_noise = self.noises(si)
            first = True
            for audio in synth.stream(tokens, prompt_tokens, cond.prompt_mel, cond.embedding,
                                      chunk_size=streamer.chunk, flow_noise=flow_noise,
                                      hift_noise=hift_noise):
                self._check_stopped()
                if first:  # 20 ms against prompt bleed
                    audio = s3gen.fade_in(torch.from_numpy(audio)).numpy()
                    first = False
                if pending is not None:
                    yield pending
                pending = AudioChunk(samples=audio, sample_rate=self.sample_rate, text=sentence)
        if pending is not None:
            pending.is_final = True
            yield pending
        else:
            yield AudioChunk(samples=np.zeros(0, np.float32), sample_rate=self.sample_rate,
                             text="", is_final=True)
