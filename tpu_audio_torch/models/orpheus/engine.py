"""Orpheus TTS engine: 8 voices and expression tags, sentence and token
streaming (port of tpu_audio/models/orpheus/engine.py: OrpheusEngine).

text → `split_into_sentences` → per sentence the prompt
"<voice>: <sentence>" → `CausalLMGenerator` (temperature 0.6, top-p 0.8,
repetition penalty 1.3 over 20 tokens) → 7-token frames → SNAC → 24 kHz.
At TOKEN granularity (the default) the LM runs in spans of STREAM_SPAN
tokens and SNAC decodes a sliding window of the frames so far: with
SNAC_CTX_FRAMES of left context and SNAC_HOLD_FRAMES held back (both past
the decoder's receptive field) and the position-keyed noise, the
concatenated stream equals the one-shot decode of the same tokens.

`load()` reads the q4 checkpoint (`models/orpheus/load.py`: the LM, SNAC
and the tokenizer, from local directories or the pre-seeded cache) onto
`device`, the card unless the caller asks for the CPU, and requantises the
LM to per-channel int8 ("w8a8", the default: the whole-stack step kernel),
repacks it to W4A8 ("w4a8": the W4A8 kernels, layer by layer) or keeps it
("q4"); `from_params` takes a tree built so (`ops/quant`). The LM cache is
sized for each request. `speculative="ngram"` (prompt lookup) or a
`DraftModel` decodes each sentence by `generate_speculative`, gamma drafts
a target pass; speculative runs keep the sentence path, as in the JAX
engine. `mesh=` (a `parallel.make_mesh` DeviceMesh with a "tp" axis)
serves the LM tensor-parallel on every quantisation (each rank its shard,
`CausalLMGenerator`); SNAC runs whole on every rank.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from tpu_audio_torch.api.results import AudioResult
from tpu_audio_torch.api.tts import AudioChunk, StreamingGranularity, TTSEngineBase
from tpu_audio_torch.codecs.snac import model as snac
from tpu_audio_torch.convert import serving_dtype, tree_device
from tpu_audio_torch.models.orpheus import model as omodel
from tpu_audio_torch.models.orpheus.model import (CausalLMGenerator, build_prompt_ids,
                                                  parse_frames)
from tpu_audio_torch.ops.sampling import SamplerConfig
from tpu_audio_torch.parallel import tp_quant
from tpu_audio_torch.utils import text as textutils
from tpu_audio_torch.utils.tokenizer import load_tokenizer

LLM_REPO = "mlx-community/orpheus-3b-0.1-ft-4bit"
SNAC_REPO = "mlx-community/snac_24khz"
QUANTIZATIONS = ("w8a8", "w4a8", "q4")


def check_speculative(speculative) -> None:
    """Refuse a `speculative=` that is none of None, "ngram", a DraftModel."""
    if not (speculative is None or speculative == "ngram"
            or isinstance(speculative, omodel.DraftModel)):
        raise ValueError(f"speculative must be None, 'ngram' or a DraftModel, "
                         f"got {speculative!r}")


def generate_sentence(lm: CausalLMGenerator, ids: list[int], sampler: SamplerConfig, eos_ids,
                      max_new: int, seed: int, speculative, gamma: int,
                      should_stop) -> list[int]:
    """A sentence's tokens: `generate` in spans the host can cancel
    between, or with `speculative` ("ngram" or a DraftModel)
    `generate_speculative`."""
    if speculative is None:
        return lm.generate(ids, sampler=sampler, eos_ids=eos_ids, max_new=max_new, seed=seed,
                           should_stop=should_stop)
    return lm.generate_speculative(ids, sampler=sampler, eos_ids=eos_ids, max_new=max_new,
                                   seed=seed, gamma=gamma,
                                   draft=None if speculative == "ngram" else speculative)


class OrpheusEngine(TTSEngineBase):
    sample_rate = omodel.SAMPLE_RATE
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,
                                         StreamingGranularity.TOKEN)
    default_streaming_granularity = StreamingGranularity.TOKEN
    voices = omodel.VOICES
    expression_tags = omodel.EXPRESSION_TAGS

    # the sliding SNAC window, in 7-token frames (4 latent frames each):
    # left context and right hold-back past the decoder's receptive field
    SNAC_CTX_FRAMES = 8
    SNAC_HOLD_FRAMES = 4
    STREAM_SPAN = 28  # LM tokens per span (4 frames)

    def __init__(self, voice: str = "tara", temperature: float = 0.6, top_p: float = 0.8,
                 quantization: str = "w8a8", mesh=None, speculative=None, gamma: int = 8,
                 device: torch.device | str = "cuda"):
        """speculative: None, "ngram" (prompt-lookup drafting) or a
        DraftModel (a same-vocabulary draft model); gamma drafts a target
        pass. mesh: a DeviceMesh with a "tp" axis, for tensor-parallel
        serving of the LM. device: the card unless the caller asks for the
        CPU."""
        super().__init__()
        if mesh is not None:
            tp_quant.tp_axis(mesh)  # refuses a non-mesh object, naming it
        check_speculative(speculative)
        if quantization not in QUANTIZATIONS:
            raise ValueError(f"quantization must be one of {QUANTIZATIONS}, got {quantization!r}")
        self.voice = voice
        self.temperature = temperature
        self.top_p = top_p
        self.quantization = quantization
        self.mesh = mesh
        self.speculative = speculative
        self.gamma = gamma
        self.device = device
        self.lm: CausalLMGenerator | None = None
        self.snac_params = None
        self.snac_cfg = snac.SNACConfig()
        self.tokenizer = None

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.orpheus import load as oload
        from tpu_audio_torch.ops import quant

        lm_params, cfg, tok, snac_params, snac_cfg = oload.load(
            LLM_REPO, SNAC_REPO, serving_dtype(self.device), self.device)
        if self.quantization == "w8a8":
            lm_params = quant.requantize_tree_int8(lm_params)
        elif self.quantization == "w4a8":
            lm_params = quant.repack_tree_w4a8(lm_params)
        self.lm = CausalLMGenerator(lm_params, cfg, max_cache=None, pad_id=omodel.PAD_TOKEN,
                                    mesh=self.mesh)
        self.tokenizer = tok
        self.snac_params = snac_params
        self.snac_cfg = snac_cfg
        self.is_loaded = True

    @classmethod
    def from_params(cls, lm_params, cfg, snac_params, snac_cfg=None,
                    max_cache: int | None = None, mesh=None, speculative=None,
                    gamma: int = 8) -> "OrpheusEngine":
        """An engine over a built LM tree (bf16, int8, q4 or W4A8) and SNAC
        parameters. The LM cache holds `max_cache` slots, or with None (the
        default) as many as each request needs. mesh: tensor-parallel
        serving of the LM, each rank holding its shard."""
        eng = cls(mesh=mesh, speculative=speculative, gamma=gamma)
        eng.lm = CausalLMGenerator(lm_params, cfg, max_cache=max_cache, pad_id=omodel.PAD_TOKEN,
                                   mesh=mesh)
        eng.snac_params = snac_params
        eng.snac_cfg = snac_cfg or snac.SNACConfig()
        eng.tokenizer = load_tokenizer(None)
        eng.is_loaded = True
        return eng

    def _sampler(self) -> SamplerConfig:
        return SamplerConfig(temperature=self.temperature, top_p=self.top_p,
                             repetition_penalty=1.3, repetition_window=omodel.REPETITION_WINDOW)

    def _prompt(self, text: str) -> list[int]:
        return build_prompt_ids(self.tokenizer.encode(f"{self.voice}: {text}"))

    # ------------------------------------------------------------ SNAC

    @torch.inference_mode()
    def _snac_window(self, layers_: list[np.ndarray], start_f: int, frames: int,
                     seed: int) -> np.ndarray:
        """Decode `frames` 7-token frames from frame start_f (codes past the
        parsed ones zero-padded), noise keyed from start_f's latent frame:
        (frames · 2048,) samples."""
        dev = tree_device(self.snac_params)
        codes = []
        for layer, s in zip(layers_, (1, 2, 4)):  # codes per frame of each level
            seg = layer[start_f * s:(start_f + frames) * s]
            seg = np.pad(seg, (0, frames * s - len(seg)))
            codes.append(torch.as_tensor(seg, dtype=torch.int64, device=dev)[None])
        audio = snac.decode_codes(self.snac_params, self.snac_cfg, codes, seed=seed,
                                  noise_pos=start_f * self.snac_cfg.vq_strides[0])
        return audio[0].float().cpu().numpy()

    def _decode_snac(self, layers_: list[np.ndarray], seed: int = 0) -> np.ndarray:
        """One-shot decode of all parsed frames, in buckets of 8 frames."""
        frames = len(layers_[0])
        if frames == 0:
            return np.zeros(0, np.float32)
        audio = self._snac_window(layers_, 0, max(8, -(-frames // 8) * 8), seed)
        return audio[:frames * self.snac_cfg.vq_strides[0] * self.snac_cfg.hop]

    def _stream_snac_window(self, layers_: list[np.ndarray], start_f: int, end_f: int,
                            emit_from_f: int, emit_to_f: int, seed: int) -> np.ndarray:
        """Decode frames [start_f, end_f) and return the samples of
        [emit_from_f, emit_to_f)."""
        spf = self.snac_cfg.vq_strides[0] * self.snac_cfg.hop  # samples per frame
        audio = self._snac_window(layers_, start_f, end_f - start_f, seed)
        return audio[(emit_from_f - start_f) * spf:(emit_to_f - start_f) * spf]

    # ------------------------------------------------------------ synthesis

    def generate_batch(self, texts: list[str], max_new_tokens: int = omodel.MAX_TOKENS,
                       seed: int = 0) -> list[AudioResult]:
        """Synthesise each text whole, all in one batched decode loop."""
        if self.lm is None:
            self.load()
        self._stop_flag.clear()
        self.is_generating = True
        t0 = time.perf_counter()
        try:
            outs = self.lm.generate_batch([self._prompt(t) for t in texts],
                                          sampler=self._sampler(), eos_ids=(omodel.END_TOKEN,),
                                          max_new=max_new_tokens, seed=seed)
            audio = [self._decode_snac(parse_frames(ids)) for ids in outs]
        finally:
            self.is_generating = False
        self.generation_time = time.perf_counter() - t0
        return [AudioResult(samples=a, sample_rate=self.sample_rate,
                            processing_time=self.generation_time) for a in audio]

    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           max_new_tokens: int = omodel.MAX_TOKENS,
                           **kw) -> Iterator[AudioChunk]:
        if self.lm is None:
            self.load()
        sentences = textutils.split_into_sentences(text)
        granularity = granularity or self.default_streaming_granularity
        if granularity not in self.supported_streaming_granularities:
            raise ValueError(f"Orpheus streams by sentence or token, not {granularity}")
        if granularity == StreamingGranularity.TOKEN and self.speculative is None:
            yield from self._stream_tokens(sentences, self._sampler(), max_new_tokens)
            return
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            generated = generate_sentence(self.lm, self._prompt(sentence), self._sampler(),
                                          (omodel.END_TOKEN,), max_new_tokens, si,
                                          self.speculative, self.gamma, self._stop_flag.is_set)
            self._check_stopped()
            yield AudioChunk(samples=self._decode_snac(parse_frames(generated)),
                             sample_rate=self.sample_rate, text=sentence,
                             is_final=si == len(sentences) - 1)

    def _stream_tokens(self, sentences: list[str], sampler: SamplerConfig,
                       max_new: int) -> Iterator[AudioChunk]:
        """LM spans of STREAM_SPAN tokens → sliding-window SNAC decodes.
        Each window is extended left to a multiple of 8 frames (extra
        context never changes the emitted samples); the last one of a
        sentence ends at the one-shot decode's bucket end."""
        ctx, hold = self.SNAC_CTX_FRAMES, self.SNAC_HOLD_FRAMES
        pending: AudioChunk | None = None
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            toks: list[int] = []
            emitted_f = 0

            def window(layers_, start_f, end_f, emit_to_f):
                start_f = max(0, start_f)
                start_f = max(0, start_f - (-(end_f - start_f)) % 8)
                return self._stream_snac_window(layers_, start_f, end_f, emitted_f, emit_to_f,
                                                si)

            for span_toks in self.lm.stream_spans(
                    self._prompt(sentence), sampler=sampler, eos_ids=(omodel.END_TOKEN,),
                    max_new=max_new, seed=si, span=self.STREAM_SPAN,
                    should_stop=self._stop_flag.is_set):
                self._check_stopped()
                toks.extend(span_toks)
                layers_ = parse_frames(toks)
                decodable = len(layers_[0]) - hold
                if decodable <= emitted_f:
                    continue
                audio = window(layers_, emitted_f - ctx, len(layers_[0]), decodable)
                emitted_f = decodable
                if len(audio):
                    if pending is not None:
                        yield pending
                    pending = AudioChunk(samples=audio, sample_rate=self.sample_rate,
                                         text=sentence, is_final=False)
            self._check_stopped()
            layers_ = parse_frames(toks)
            total = len(layers_[0])
            if total > emitted_f:  # the one-shot bucket's end, zero-padded alike
                audio = window(layers_, emitted_f - ctx, max(8, -(-total // 8) * 8), total)
                emitted_f = total
                if len(audio):
                    if pending is not None:
                        yield pending
                    pending = AudioChunk(samples=audio, sample_rate=self.sample_rate,
                                         text=sentence, is_final=False)
        if pending is not None:
            yield AudioChunk(samples=pending.samples, sample_rate=pending.sample_rate,
                             text=pending.text, is_final=True)
        else:
            yield AudioChunk(samples=np.zeros(0, np.float32), sample_rate=self.sample_rate,
                             text="", is_final=True)
