"""Chatterbox engine: voice cloning with emotion exaggeration (port of
tpu_audio/models/chatterbox/engine.py: S3_SR, S3GEN_SR, ENC_COND_SECONDS,
DEC_COND_SECONDS, ChatterboxConditionals, punc_norm, ChatterboxEngine).

`prepare_conditionals` makes a reusable speaker from reference audio: the
reference resampled to 24 and 16 kHz; the S3 tokens of its first 10 s
(S3Gen's prompt) and of its first 6 s (T3's conditioning); S3Gen's prompt
mel of the first 10 s at 24 kHz, cut or zero-padded to 2 frames a prompt
token; the CAMPPlus x-vector of the whole reference's mean-normalised
Kaldi fbank; the voice encoder's embedding over its sliding partials. The
JAX engine jits those steps into one function a length; here they run
eagerly, one function a step. Without a speaker the zero speaker serves.
Each sentence: `punc_norm` → [start_text] + BPE ids + [stop_text], each id
clamped to T3's vocabulary → the T3 CFG decode → the S3Gen pass over the
tokens padded to a multiple of 25 (CFG flow + HiFT) → a 20 ms fade-in.
Streaming is SENTENCE-granular.

`load()` reads mlx-community/Chatterbox-TTS-{fp16,8bit,4bit} and
S3TokenizerV2 (`load.py`) onto `device` (the card unless the caller asks
for the CPU); the T3 of the 8bit/4bit trees serves as stored, its linears
through `quant_matmul`. `from_params` takes built trees; its T3 cache is
sized for each request, where the JAX engine's `max_cache=512` clamps a
long sentence's writes (ROADMAP C22). The draws: T3 from a
`torch.Generator` seeded by the sentence's index, S3Gen's from
`noise.Noise` of that index (`noises`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from tpu_audio_torch.api.tts import AudioChunk, StreamingGranularity, TTSEngineBase
from tpu_audio_torch.codecs.s3gen import model as s3gen
from tpu_audio_torch.codecs.s3gen.noise import Noise
from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
from tpu_audio_torch.convert import tree_device
from tpu_audio_torch.models.chatterbox import t3 as t3mod
from tpu_audio_torch.models.chatterbox import voice_encoder as ve
from tpu_audio_torch.ops import frontends
from tpu_audio_torch.ops.resample import resample
from tpu_audio_torch.utils import text as textutils
from tpu_audio_torch.utils.tokenizer import load_tokenizer

S3_SR = 16000
S3GEN_SR = 24000
ENC_COND_SECONDS = 6
DEC_COND_SECONDS = 10
TOKEN_BUCKET = 25  # token2wav pads the tokens to a multiple


@dataclass
class ChatterboxConditionals:
    """A prepared speaker."""

    speaker_emb: torch.Tensor  # (1, 256) voice encoder
    t3_cond_tokens: torch.Tensor  # (1, P) S3 tokens of the first 6 s (T3)
    prompt_tokens: torch.Tensor  # (1, P2) S3 tokens of the first 10 s (S3Gen)
    prompt_mel: torch.Tensor  # (1, 2·P2, 80)
    embedding: torch.Tensor  # (1, 192) CAMPPlus
    exaggeration: float = 0.5


def punc_norm(text: str) -> str:
    """Capitalise, normalise punctuation, end with a terminal mark."""
    text = " ".join(text.split())
    if not text:
        return "You need to add some text for me to talk."
    if text[0].islower():
        text = text[0].upper() + text[1:]
    for a, b in (("...", ", "), ("…", ", "), (":", ","), (" - ", ", "),
                 (";", ", "), ("—", "-"), ("–", "-"), (" ,", ","),
                 ("“", '"'), ("”", '"'), ("‘", "'"), ("’", "'")):
        text = text.replace(a, b)
    if text[-1] not in ".!?-\"'":
        text = text + "."
    return text


def resampled(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    return (resample(audio, sr_in, sr_out) if sr_in != sr_out
            else np.asarray(audio, np.float32))


class ChatterboxEngine(TTSEngineBase):
    sample_rate = S3GEN_SR
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,)

    def __init__(self, temperature: float = 0.8, top_p: float = 0.95, min_p: float = 0.05,
                 repetition_penalty: float = 1.2, cfg_weight: float = 0.5,
                 exaggeration: float = 0.5, variant: str = "fp16",
                 device: torch.device | str = "cuda"):
        """variant: the checkpoint `load()` reads ("fp16", "8bit" or "4bit")."""
        super().__init__()
        self.temperature = temperature
        self.top_p = top_p
        self.min_p = min_p
        self.repetition_penalty = repetition_penalty
        self.cfg_weight = cfg_weight
        self.exaggeration = exaggeration
        self.variant = variant
        self.device = device
        self.t3_params = None
        self.t3_cfg = t3mod.T3Config()
        self.t3_gen: t3mod.T3Generator | None = None
        self.s3gen_params = None
        self.s3gen_cfg = s3gen.S3GenConfig()
        self.tok_params = None
        self.tok_cfg = s3tok.S3TokenizerConfig()
        self.ve_params = None
        self.ve_cfg = ve.VoiceEncConfig()
        self.tokenizer = None
        self.conditionals: ChatterboxConditionals | None = None

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.chatterbox import load as cload

        (self.t3_params, self.t3_cfg, self.s3gen_params, self.s3gen_cfg, self.tok_params,
         self.tok_cfg, self.ve_params, self.ve_cfg,
         self.tokenizer) = cload.load(self.variant, device=self.device)
        self.t3_gen = t3mod.T3Generator(self.t3_params, self.t3_cfg)
        self.is_loaded = True

    @classmethod
    def from_params(cls, t3_params, t3_cfg, s3gen_params, s3gen_cfg, tok_params, tok_cfg,
                    ve_params, ve_cfg, tokenizer=None,
                    max_cache: int | None = None) -> "ChatterboxEngine":
        """An engine over built trees (T3 fp or group-affine q4/q8) on their
        device. The T3 cache holds `max_cache` slots, or with None (the
        default) as many as each request needs."""
        eng = cls(device=tree_device(s3gen_params))
        eng.t3_params, eng.t3_cfg = t3_params, t3_cfg
        eng.s3gen_params, eng.s3gen_cfg = s3gen_params, s3gen_cfg
        eng.tok_params, eng.tok_cfg = tok_params, tok_cfg
        eng.ve_params, eng.ve_cfg = ve_params, ve_cfg
        eng.tokenizer = tokenizer or load_tokenizer(None)
        eng.t3_gen = t3mod.T3Generator(t3_params, t3_cfg, max_cache=max_cache)
        eng.is_loaded = True
        return eng

    # ---------------------------------------------------------------- speaker

    def _dev(self) -> torch.device:
        return tree_device(self.s3gen_params)

    def speech_tokens(self, audio16: np.ndarray) -> torch.Tensor:
        """The S3 tokens (1, P) of 16 kHz audio."""
        mel = frontends.s3_log_mel(torch.as_tensor(audio16, dtype=torch.float32,
                                                   device=self._dev())).T[None]
        dt = self.tok_params["encoder"]["conv1"]["weight"].dtype
        codes, lens = s3tok.quantize(self.tok_params, self.tok_cfg, mel.to(dt), mel.shape[1])
        return codes[:, : int(lens[0])]

    def prompt_mel(self, audio24: np.ndarray, n_tokens: int) -> torch.Tensor:
        """S3Gen's mel (1, 2·n_tokens, 80) of 24 kHz audio, cut or zero-padded."""
        mel = frontends.s3gen_mel(torch.as_tensor(audio24, dtype=torch.float32,
                                                  device=self._dev()),
                                  n_mels=self.s3gen_cfg.mel_dim).T[None]
        want = 2 * n_tokens
        pm = mel[:, :want]
        if pm.shape[1] < want:
            pm = torch.nn.functional.pad(pm, (0, 0, 0, want - pm.shape[1]))
        return pm

    def xvector(self, audio16: np.ndarray) -> torch.Tensor:
        """The CAMPPlus x-vector (1, 192) of the mean-normalised Kaldi fbank."""
        fbank = frontends.kaldi_fbank(torch.as_tensor(audio16, dtype=torch.float32,
                                                      device=self._dev()))
        fbank = fbank - fbank.mean(dim=0, keepdim=True)
        dt = self.s3gen_params["flow"]["input_embedding"]["weight"].dtype
        return s3gen.embed_ref_mel(self.s3gen_params, self.s3gen_cfg, fbank[None].to(dt))

    def speaker_embedding(self, audio16: np.ndarray) -> torch.Tensor:
        """The voice encoder's embedding (1, 256)."""
        return ve.embed_utterance(self.ve_params, self.ve_cfg, audio16)[None]

    @torch.inference_mode()
    def prepare_conditionals(self, ref_audio: np.ndarray, sample_rate: int,
                             exaggeration: float | None = None) -> ChatterboxConditionals:
        ref24 = resampled(ref_audio, sample_rate, S3GEN_SR)
        ref16 = resampled(ref_audio, sample_rate, S3_SR)
        prompt_tokens = self.speech_tokens(ref16[: DEC_COND_SECONDS * S3_SR])
        cond = ChatterboxConditionals(
            speaker_emb=self.speaker_embedding(ref16),
            t3_cond_tokens=self.speech_tokens(ref16[: ENC_COND_SECONDS * S3_SR]),
            prompt_tokens=prompt_tokens,
            prompt_mel=self.prompt_mel(ref24[: DEC_COND_SECONDS * S3GEN_SR],
                                       prompt_tokens.shape[1]),
            embedding=self.xvector(ref16),
            exaggeration=self.exaggeration if exaggeration is None else exaggeration)
        self.conditionals = cond
        return cond

    def _default_conditionals(self) -> ChatterboxConditionals:
        """The zero speaker, so that the engine runs without a reference."""
        dev, d = self._dev(), self.s3gen_cfg.mel_dim
        return ChatterboxConditionals(
            speaker_emb=torch.zeros((1, self.t3_cfg.speaker_embed_size), device=dev),
            t3_cond_tokens=torch.zeros((1, 8), dtype=torch.int64, device=dev),
            prompt_tokens=torch.zeros((1, 4), dtype=torch.int64, device=dev),
            prompt_mel=torch.zeros((1, 8, d), device=dev),
            embedding=torch.zeros((1, self.s3gen_cfg.spk_dim), device=dev))

    # ---------------------------------------------------------------- synthesis

    @staticmethod
    def noises(seed: int):
        """(the flow's draws, HiFT's draws) of a sentence with this seed."""
        return Noise(seed), Noise(seed)

    @torch.inference_mode()
    def _token2wav(self, speech_tokens, cond: ChatterboxConditionals, seed: int) -> np.ndarray:
        """One S3Gen pass over the tokens padded to a multiple of 25 (token
        0 after the last), cut to the generated samples and faded in."""
        n = len(speech_tokens)
        if n == 0:
            return np.zeros(0, np.float32)
        dev = self._dev()
        bucket = -(-n // TOKEN_BUCKET) * TOKEN_BUCKET
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n] = torch.as_tensor(list(speech_tokens), dtype=torch.int64)
        pt = cond.prompt_tokens
        audio, start, valid = s3gen.token2wav(
            self.s3gen_params, self.s3gen_cfg, toks.to(dev), n, pt, pt.shape[1],
            cond.prompt_mel, cond.prompt_mel.shape[1], cond.embedding, *self.noises(seed))
        return s3gen.fade_in(audio[0, start: start + valid].float()).cpu().numpy()

    def sampler(self) -> t3mod.T3SamplerConfig:
        return t3mod.T3SamplerConfig(temperature=self.temperature, top_p=self.top_p,
                                     min_p=self.min_p, repetition_penalty=self.repetition_penalty,
                                     cfg_weight=self.cfg_weight)

    def text_ids(self, sentence: str) -> list[int]:
        """[start_text] + the BPE ids of the normalised sentence +
        [stop_text], each clamped to T3's text vocabulary."""
        cfg = self.t3_cfg
        ids = [cfg.start_text_token] + self.tokenizer.encode(punc_norm(sentence)) + [
            cfg.stop_text_token]
        return [min(i, cfg.text_tokens_dict_size - 1) for i in ids]

    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           max_new_tokens: int = 600, **kw) -> Iterator[AudioChunk]:
        if self.t3_gen is None:
            self.load()
        cond = self.conditionals or self._default_conditionals()
        with torch.inference_mode():
            cond_emb = t3mod.prepare_conditioning(self.t3_params, self.t3_cfg, cond.speaker_emb,
                                                  cond.t3_cond_tokens, cond.exaggeration)
        sampler = self.sampler()
        sentences = textutils.split_into_sentences(text)
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            speech = self.t3_gen.generate(cond_emb, self.text_ids(sentence), sampler=sampler,
                                          max_new=max_new_tokens, seed=si)
            audio = self._token2wav(speech, cond, si)
            yield AudioChunk(samples=audio, sample_rate=self.sample_rate, text=sentence,
                             is_final=si == len(sentences) - 1)
