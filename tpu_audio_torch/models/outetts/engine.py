"""OuteTTS engine: Llama-3.2-1B → interleaved c1/c2 DAC codes → 24 kHz
(port of tpu_audio/models/outetts/engine.py: SAMPLER, normalize_text,
merge_speaker_text, build_prompt, extract_codes, default_speaker,
OuteTTSEngine).

text → `split_into_sentences` → per sentence the prompt of `build_prompt`
(with the speaker profile's words and codes, or none) → `CausalLMGenerator`
(temperature 0.4, top-p 0.9, top-k 40, min-p 0.05, repetition penalty 1.1
over 64 tokens) → the <|c1_N|><|c2_M|> pairs of the generated text → DAC,
decoded in buckets of 25 frames as the JAX engine decodes them (DAC is not
causal: the zero codes of the bucket reach the last real frames).

`load()` reads the q4 checkpoint (`nn/load_llama`, the `tokenizer.json`
reader) and the DAC checkpoint (`codecs/dac/load.py`) onto `device`, the
card unless the caller asks for the CPU, and requantises the LM to
per-channel int8 ("w8a8", the default: the whole-stack step kernel and the
int8 head), repacks it to W4A8 ("w4a8") or keeps it ("q4"). `from_params`
takes a tree built so; its LM cache is sized for each request, where the
JAX engine's `max_cache=512` cannot hold its own default of 2048 new
tokens (ROADMAP C7). `speculative="ngram"` or a `DraftModel` decodes
each sentence by `generate_speculative` (gamma drafts a target pass). The
bundled
`default_speaker.json` is not in the repository: `speaker="default"` logs
the JAX package's warning and runs unconditioned, as the reference does.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Iterator

import numpy as np
import torch

from tpu_audio_torch.api.results import AudioResult
from tpu_audio_torch.api.tts import AudioChunk, StreamingGranularity, TTSEngineBase
from tpu_audio_torch.codecs.dac import model as dac
from tpu_audio_torch.convert import serving_dtype, tree_device
from tpu_audio_torch.models.orpheus.engine import check_speculative, generate_sentence
from tpu_audio_torch.models.orpheus.model import CausalLMGenerator
from tpu_audio_torch.models.outetts import tokens as T
from tpu_audio_torch.models.outetts.features import extract_features
from tpu_audio_torch.models.outetts.tokens import SpeakerProfile, WordData
from tpu_audio_torch.ops.sampling import SamplerConfig
from tpu_audio_torch.utils import text as textutils
from tpu_audio_torch.utils.tokenizer import load_tokenizer

LLM_REPO = "mlx-community/Llama-OuteTTS-1.0-1B-4bit"
DAC_REPO = "mlx-community/dac-speech-24khz-1.5kbps"
QUANTIZATIONS = ("w8a8", "w4a8", "q4")
DAC_BUCKET = 25  # frames; the decode pads the codes with code 0 up to a multiple

SAMPLER = SamplerConfig(temperature=0.4, top_p=0.9, top_k=40, min_p=0.05,
                        repetition_penalty=1.1, repetition_window=64)

_C1_RE = re.compile(r"<\|c1_(\d+)\|>")
_C2_RE = re.compile(r"<\|c2_(\d+)\|>")
_log = logging.getLogger("tpu_audio_torch.tts")


def normalize_text(text: str) -> str:
    text = re.sub(r"\s+", " ", text).strip()
    for a, b in (("…", "..."), ("“", '"'), ("”", '"'), ("‘", "'"),
                 ("’", "'"), ("–", "-"), ("—", "-")):
        text = text.replace(a, b)
    return "".join(ch for ch in text if ord(ch) > 0x1F and not (0x7F <= ord(ch) <= 0x9F))


def merge_speaker_text(input_text: str, speaker_text: str) -> tuple[str, str]:
    """(the speaker's text joined to the input, the separator it ended with)."""
    sp = speaker_text.strip()
    cjk = any(0x3040 <= ord(c) <= 0x30FF or 0x4E00 <= ord(c) <= 0x9FFF for c in sp)
    sep = "。" if cjk else ". "
    allowed = ("。", "？", "！", "?", "!") if sep == "。" else (".", "?", "!")
    rs = ""
    if sp:
        if not sp.endswith(allowed):
            rs = sep
        elif sep != "。":
            rs = " "
    return sp + rs + input_text.strip(), rs.strip()


def build_prompt(text: str, speaker: SpeakerProfile | None) -> str:
    text = normalize_text(text)
    if speaker is not None:
        merged, sep = merge_speaker_text(text, speaker.text)
        words = [WordData(**{**w.__dict__}) for w in speaker.words]
        if words:
            words[-1].word += sep
        prompt = T.BOS + T.TEXT_START + merged + T.TEXT_END + "\n" + T.AUDIO_START + "\n"
        prompt += "\n".join(w.to_codes() for w in words)
        if words:
            prompt += "\n"
        return prompt
    return T.BOS + T.TEXT_START + text + T.TEXT_END + "\n" + T.AUDIO_START + "\n"


def extract_codes(generated_text: str) -> tuple[np.ndarray, np.ndarray]:
    """The paired c1/c2 code streams of a generated token string."""
    c1 = [int(m) for m in _C1_RE.findall(generated_text)]
    c2 = [int(m) for m in _C2_RE.findall(generated_text)]
    n = min(len(c1), len(c2))
    return np.asarray(c1[:n], np.int32), np.asarray(c2[:n], np.int32)


#: the bundled default speaker profile (the reference ships
#: default_speaker.json as a package resource); made from reference audio
#: on a machine with network access, so absent here
DEFAULT_SPEAKER_PATH = os.path.join(os.path.dirname(__file__), "default_speaker.json")


def default_speaker() -> SpeakerProfile | None:
    """The bundled default voice, or None, with a loud warning, when the
    asset has not been made: running unconditioned differs from the
    reference's out-of-the-box voice, and the user must see that."""
    if not os.path.exists(DEFAULT_SPEAKER_PATH):
        _log.warning(
            "OuteTTS bundled default speaker asset is missing (%s): "
            "generation will run UNCONDITIONED (no voice cloning prompt), "
            "which does not match the reference's out-of-the-box voice. "
            "Generate it once with tools/make_default_speaker.py on a "
            "machine with network access, or pass an explicit "
            "SpeakerProfile / speaker=None to silence this warning.",
            DEFAULT_SPEAKER_PATH)
        return None
    return SpeakerProfile.load(DEFAULT_SPEAKER_PATH)


class OuteTTSEngine(TTSEngineBase):
    sample_rate = 24000
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,)

    def __init__(self, speaker: SpeakerProfile | str | None = "default",
                 quantization: str = "w8a8", speculative=None, gamma: int = 8,
                 device: torch.device | str = "cuda"):
        """speaker: a SpeakerProfile, "default" (the bundled profile; with
        the asset absent, unconditioned prompts and a warning) or None
        (unconditioned prompts). quantization: how `load()` serves the
        4-bit checkpoint ("w8a8", "w4a8" or "q4"). speculative: None,
        "ngram" or a DraftModel, gamma drafts a target pass. device: the card unless
        the caller asks for the CPU."""
        super().__init__()
        check_speculative(speculative)
        if quantization not in QUANTIZATIONS:
            raise ValueError(f"quantization must be one of {QUANTIZATIONS}, got {quantization!r}")
        self.speaker = default_speaker() if speaker == "default" else speaker
        self.speculative = speculative
        self.gamma = gamma
        self.quantization = quantization
        self.device = device
        self.lm: CausalLMGenerator | None = None
        self.tokenizer = None
        self.dac_params = None
        self.dac_cfg = dac.DACConfig()
        self._audio_end_id = None

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.codecs.dac import load as dac_load
        from tpu_audio_torch.nn import load_llama
        from tpu_audio_torch.ops import quant
        from tpu_audio_torch.utils import hub

        path = hub.snapshot(LLM_REPO)
        params, cfg = load_llama.load_llama_dir(path, serving_dtype(self.device), self.device)
        if self.quantization == "w8a8":
            params = quant.requantize_tree_int8(params)
        elif self.quantization == "w4a8":
            params = quant.repack_tree_w4a8(params)
        self.lm = CausalLMGenerator(params, cfg, max_cache=4096)
        self.tokenizer = load_tokenizer(path)
        self.dac_params, self.dac_cfg = dac_load.load_dir(hub.snapshot(DAC_REPO),
                                                          device=self.device)
        self.is_loaded = True

    @classmethod
    def from_params(cls, lm_params, cfg, dac_params, dac_cfg, tokenizer=None,
                    max_cache: int | None = None, speculative=None,
                    gamma: int = 8) -> "OuteTTSEngine":
        """An engine over a built LM tree (bf16, int8, q4 or W4A8) and DAC
        parameters. The LM cache holds `max_cache` slots, or with None (the
        default) as many as each request needs."""
        eng = cls(speculative=speculative, gamma=gamma)
        eng.lm = CausalLMGenerator(lm_params, cfg, max_cache=max_cache)
        eng.tokenizer = tokenizer or load_tokenizer(None)
        eng.dac_params = dac_params
        eng.dac_cfg = dac_cfg
        eng.is_loaded = True
        return eng

    # ---------------------------------------------------------------- speaker

    @torch.inference_mode()
    def create_speaker(self, audio: np.ndarray, sample_rate: int,
                       transcript: str | None = None, whisper_engine=None) -> SpeakerProfile:
        """A speaker profile from reference audio: Whisper word timestamps,
        then each word's DAC codes and acoustic features."""
        from tpu_audio_torch.ops.resample import resample

        audio16 = resample(audio, sample_rate, 16000) if sample_rate != 16000 else audio
        if whisper_engine is None:
            from tpu_audio_torch.api.stt import STT

            whisper_engine = STT.whisper("tiny", device=self.device)
        result = whisper_engine.transcribe(audio16, word_timestamps=True)
        audio24 = resample(audio, sample_rate, 24000) if sample_rate != 24000 else audio
        dev = tree_device(self.dac_params)
        profile_words = []
        hop = self.dac_cfg.hop
        for w in result.words:
            seg = audio24[int(w.start * 24000): int(w.end * 24000)]
            if len(seg) < hop:
                continue
            seg = seg[: len(seg) // hop * hop]
            x = torch.as_tensor(np.asarray(seg, np.float32), device=dev)[None]
            codes = dac.encode(self.dac_params, self.dac_cfg, x).cpu().numpy()
            profile_words.append(WordData(
                word=w.word, duration=round(w.end - w.start, 2),
                features=extract_features(seg, 24000),
                c1=[int(c) for c in codes[0, 0]], c2=[int(c) for c in codes[0, 1]]))
        return SpeakerProfile(text=transcript or result.text, words=profile_words,
                              global_features=extract_features(audio24, 24000))

    # ---------------------------------------------------------------- synthesis

    @torch.inference_mode()
    def _decode_dac(self, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
        """The waveform of paired codes, decoded in a bucket of DAC_BUCKET
        frames (code 0 after the last) and cut to frames · hop samples."""
        frames = len(c1)
        if frames == 0:
            return np.zeros(0, np.float32)
        bucket = -(-frames // DAC_BUCKET) * DAC_BUCKET
        codes = np.zeros((1, 2, bucket), np.int64)
        codes[0, 0, :frames] = c1
        codes[0, 1, :frames] = c2
        codes = torch.as_tensor(codes, device=tree_device(self.dac_params))
        audio = dac.decode_codes(self.dac_params, self.dac_cfg, codes)
        return audio[0, : frames * self.dac_cfg.hop].float().cpu().numpy()

    def generate_batch(self, texts: list[str], max_new_tokens: int = 2048,
                       seed: int = 0) -> list[AudioResult]:
        """Synthesise each text whole, all in one batched decode loop (the
        weights stream once a step for the whole batch)."""
        if self.lm is None:
            self.load()
        self._stop_flag.clear()
        self.is_generating = True
        t0 = time.perf_counter()
        try:
            prompts = [self.tokenizer.encode(build_prompt(t, self.speaker)) for t in texts]
            outs = self.lm.generate_batch(prompts, sampler=SAMPLER, eos_ids=self._eos_ids(),
                                          max_new=max_new_tokens, seed=seed)
            audio = [self._decode_dac(*extract_codes(self.tokenizer.decode_raw(ids)))
                     for ids in outs]
        finally:
            self.is_generating = False
        self.generation_time = time.perf_counter() - t0
        return [AudioResult(samples=a, sample_rate=self.sample_rate,
                            processing_time=self.generation_time) for a in audio]

    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           max_new_tokens: int = 2048, **kw) -> Iterator[AudioChunk]:
        if self.lm is None:
            self.load()
        sentences = textutils.split_into_sentences(text)
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            ids = self.tokenizer.encode(build_prompt(sentence, self.speaker))
            generated = generate_sentence(self.lm, ids, SAMPLER, self._eos_ids(),
                                          max_new_tokens, si, self.speculative, self.gamma,
                                          self._stop_flag.is_set)
            self._check_stopped()
            c1, c2 = extract_codes(self.tokenizer.decode_raw(generated))
            yield AudioChunk(samples=self._decode_dac(c1, c2), sample_rate=self.sample_rate,
                             text=sentence, is_final=si == len(sentences) - 1)

    def _eos_ids(self) -> tuple:
        """<|audio_end|>'s id where the tokenizer has it as one token, else 2."""
        if self._audio_end_id is None:
            ids = self.tokenizer.encode(T.AUDIO_END)
            self._audio_end_id = tuple(ids) if len(ids) == 1 else (2,)
        return self._audio_end_id
