"""CosyVoice3 engine: token-granularity streaming TTS (port of
tpu_audio/models/cosyvoice3/engine.py: CosyVoice3Engine).

The LM is CosyVoice2's (`models/cosyvoice2/lm.py`: Qwen2-0.5B, RAS), its
streamer's first chunk taking the flow's 3 tokens of pre-lookahead; the
flow is the DiT's (`model.CV3Synthesizer`), the vocoder the causal HiFT.
Modes: zero-shot (the speaker's prompt text), cross-lingual (none),
instruct (the instruction + "<|endofprompt|>"), and `voice_conversion`
(the source's S3 tokens through the flow, no LM). A speaker
(`CosyVoice2Speaker`) holds the reference's S3 tokens, its 24 kHz mel and a
zero x-vector, as the JAX engine makes it. TOKEN granularity (the default)
yields each chunk's audio and a final empty chunk; SENTENCE one chunk a
sentence.

`load()` reads the 4-bit checkpoint and S3TokenizerV3 (`load.py`) onto
`device` (the card unless the caller asks for the CPU) and serves the LM
as per-channel int8 ("w8a8", the default), W4A8 ("w4a8"), as it is
("q4") or dequantised ("bf16", "fp16", "none", as CosyVoice2's engine).
`from_params` takes built trees; its LM cache is sized for each request
(the JAX engine's `max_cache=512` clamps, ROADMAP C18).
`speculative="ngram"` streams the LM through the speculative loop.
`from_params(mesh=)` (a `parallel.make_mesh` DeviceMesh with a "tp" axis)
serves the LM through `lm.CosyLMGenerator`'s mesh (tensor-parallel on an fp
tree, replicated on a quantised one) and the DiT by local shards under
`parallel.flow_rules` (`cv3.tp_config`'s heads); the causal HiFT stays
whole on every rank, as in the JAX engine.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from tpu_audio_torch.api.tts import AudioChunk, StreamingGranularity, TTSEngineBase
from tpu_audio_torch.codecs.s3gen.noise import Noise
from tpu_audio_torch.codecs.s3tokenizer import model as s3tok
from tpu_audio_torch.convert import tree_device
from tpu_audio_torch.models.cosyvoice2 import lm as lm_mod
from tpu_audio_torch.models.cosyvoice2.engine import (ENDOFPROMPT, FP_QUANTIZATIONS, MODES,
                                                      QUANTIZATIONS, SR_OUT, SR_TOK,
                                                      CosyVoice2Speaker, fp_lm)
from tpu_audio_torch.models.cosyvoice3 import model as cv3
from tpu_audio_torch.ops import frontends
from tpu_audio_torch.ops.resample import resample
from tpu_audio_torch.parallel import tp_quant
from tpu_audio_torch.parallel.shardings import flow_rules, local_tree
from tpu_audio_torch.utils import text as textutils
from tpu_audio_torch.utils.tokenizer import load_tokenizer


class CosyVoice3Engine(TTSEngineBase):
    sample_rate = SR_OUT
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,
                                         StreamingGranularity.TOKEN)
    default_streaming_granularity = StreamingGranularity.TOKEN

    def __init__(self, quantization: str = "w8a8", speculative: str | None = None,
                 gamma: int = 4, device: torch.device | str = "cuda"):
        super().__init__()
        lm_mod.check_speculative(speculative)
        if quantization not in QUANTIZATIONS:
            raise ValueError(f"quantization must be one of {QUANTIZATIONS}, got {quantization!r}")
        self.quantization = quantization
        self.speculative = speculative
        self.gamma = gamma
        self.device = device
        self.lm: lm_mod.CosyLMGenerator | None = None
        self.lm_cfg = lm_mod.CosyLMConfig()
        self.streamer: lm_mod.CosyLMStreamer | None = None
        self.flow_params = None
        self.flow_cfg = cv3.CV3FlowConfig()
        self.synth: cv3.CV3Synthesizer | None = None
        self.tok_params = None
        self.tok_cfg = s3tok.S3TokenizerConfig()
        self.tokenizer = None
        self.speaker: CosyVoice2Speaker | None = None
        self._whisper = None

    def _serve(self, lm_params, lm_cfg, flow_params, flow_cfg, max_cache=None, chunk=25,
               mesh=None):
        self.lm_cfg = lm_cfg
        self.lm = lm_mod.CosyLMGenerator(lm_params, lm_cfg, max_cache=max_cache, mesh=mesh)
        if mesh is not None:
            flow_params = local_tree(flow_params, mesh, flow_rules)
            flow_cfg = cv3.tp_config(flow_cfg, tp_quant.tp_axis(mesh)[2])
        self.streamer = lm_mod.CosyLMStreamer(self.lm, chunk=chunk, first_extra=cv3.PRE_LOOKAHEAD)
        self.flow_params, self.flow_cfg = flow_params, flow_cfg
        self.synth = cv3.CV3Synthesizer(flow_params, flow_cfg)

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.cosyvoice3 import load as cvload
        from tpu_audio_torch.ops import quant

        (lm_params, lm_cfg, flow_params, flow_cfg, self.tok_params, self.tok_cfg,
         self.tokenizer) = cvload.load(device=self.device)
        if self.quantization == "w8a8":
            lm_params = quant.requantize_tree_int8(lm_params)
        elif self.quantization == "w4a8":
            lm_params = quant.repack_tree_w4a8(lm_params)
        elif self.quantization in FP_QUANTIZATIONS:
            lm_params = fp_lm(lm_params, self.quantization, self.device)
        self._serve(lm_params, lm_cfg, flow_params, flow_cfg)
        self.is_loaded = True

    @classmethod
    def from_params(cls, lm_params, lm_cfg, flow_params, flow_cfg, tok_params, tok_cfg,
                    tokenizer=None, max_cache: int | None = None, chunk: int = 8,
                    speculative: str | None = None, gamma: int = 4,
                    mesh=None) -> "CosyVoice3Engine":
        """An engine over built trees (the LM bf16, int8, q4 or W4A8); the
        LM streams chunks of `chunk` tokens. The LM cache holds `max_cache`
        slots, or with None (the default) as many as each request needs.
        mesh: a DeviceMesh with a "tp" axis (tensor-parallel LM and DiT)."""
        if mesh is not None:
            tp_quant.tp_axis(mesh)  # refuses a non-mesh object, naming it
        eng = cls(speculative=speculative, gamma=gamma, device=tree_device(flow_params))
        eng._serve(lm_params, lm_cfg, flow_params, flow_cfg, max_cache, chunk, mesh)
        eng.tok_params, eng.tok_cfg = tok_params, tok_cfg
        eng.tokenizer = tokenizer or load_tokenizer(None)
        eng.is_loaded = True
        return eng

    # ---------------------------------------------------------------- speaker

    def _dev(self) -> torch.device:
        return tree_device(self.flow_params)

    def speech_tokens(self, audio16: np.ndarray) -> list[int]:
        """The S3 tokens of 16 kHz audio."""
        mel = frontends.s3_log_mel(torch.as_tensor(audio16, dtype=torch.float32,
                                                   device=self._dev())).T[None]
        dt = self.tok_params["encoder"]["conv1"]["weight"].dtype
        codes, lens = s3tok.quantize(self.tok_params, self.tok_cfg, mel.to(dt), mel.shape[1])
        return codes[0, : int(lens[0])].tolist()

    @torch.inference_mode()
    def prepare_conditionals(self, ref_audio: np.ndarray, sample_rate: int,
                             ref_text: str | None = None) -> CosyVoice2Speaker:
        ref16 = (resample(ref_audio, sample_rate, SR_TOK) if sample_rate != SR_TOK
                 else np.asarray(ref_audio, np.float32))
        if len(ref16) < 640:
            raise ValueError(f"reference audio too short ({len(ref16)} samples at 16 kHz); "
                             "need at least one tokenizer frame (~40 ms)")
        ref24 = (resample(ref_audio, sample_rate, SR_OUT) if sample_rate != SR_OUT
                 else np.asarray(ref_audio, np.float32))
        if ref_text is None:
            if self._whisper is None:
                from tpu_audio_torch.api.stt import STT

                self._whisper = STT.whisper("tiny", device=self.device)
            ref_text = self._whisper.transcribe(ref16).text.strip()
        dev = self._dev()
        tokens = self.speech_tokens(ref16)
        mel = frontends.s3gen_mel(torch.as_tensor(ref24, dtype=torch.float32, device=dev),
                                  n_mels=self.flow_cfg.mel_dim).T[None]
        want = self.flow_cfg.token_mel_ratio * len(tokens)
        pm = mel[:, :want]
        if pm.shape[1] < want:
            pm = torch.nn.functional.pad(pm, (0, 0, 0, want - pm.shape[1]))
        self.speaker = CosyVoice2Speaker(
            prompt_text=ref_text, prompt_text_ids=self.tokenizer.encode(ref_text),
            speech_tokens=tokens, prompt_mel=pm,
            embedding=torch.zeros((1, self.flow_cfg.spk_dim), device=dev))
        return self.speaker

    def default_speaker(self) -> CosyVoice2Speaker:
        dev = self._dev()
        return CosyVoice2Speaker(
            prompt_text="", prompt_text_ids=[], speech_tokens=[0, 1],
            prompt_mel=torch.zeros((1, 4, self.flow_cfg.mel_dim), device=dev),
            embedding=torch.zeros((1, self.flow_cfg.spk_dim), device=dev))

    @staticmethod
    def noises(seed: int):
        """(the flow's draws, HiFT's draws) of a request with this seed."""
        return Noise(seed), Noise(seed)

    # ---------------------------------------------------------------- VC

    def voice_conversion(self, source_audio: np.ndarray, sample_rate: int,
                         speaker: CosyVoice2Speaker | None = None) -> np.ndarray:
        """The source's S3 tokens through the flow with the speaker's prompt
        tokens, mel and embedding, and HiFT: one finalize pass, no LM."""
        if self.synth is None:
            self.load()
        spk = speaker or self.speaker or self.default_speaker()
        src16 = (resample(source_audio, sample_rate, SR_TOK) if sample_rate != SR_TOK
                 else np.asarray(source_audio, np.float32))
        if len(src16) < 640:  # shorter than one tokenizer frame
            return np.zeros(0, np.float32)
        with torch.inference_mode():
            tokens = self.speech_tokens(src16)
        if not tokens:
            return np.zeros(0, np.float32)
        flow_noise, hift_noise = self.noises(0)
        parts = list(self.synth.stream(iter([tokens]), spk.speech_tokens, spk.prompt_mel,
                                       spk.embedding, chunk_size=len(tokens),
                                       flow_noise=flow_noise, hift_noise=hift_noise))
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    # ---------------------------------------------------------------- synthesis

    def _prompt_ids(self, spk: CosyVoice2Speaker, mode: str, instruct_text: str | None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        if mode == "instruct" and instruct_text:
            return self.tokenizer.encode(instruct_text + ENDOFPROMPT)
        return spk.prompt_text_ids if mode == "zero_shot" else []

    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           mode: str = "zero_shot", instruct_text: str | None = None,
                           **kw) -> Iterator[AudioChunk]:
        if self.lm is None:
            self.load()
        granularity = granularity or self.default_streaming_granularity
        if granularity not in self.supported_streaming_granularities:
            raise ValueError(f"CosyVoice3 streams by sentence or token, not {granularity}")
        spk = self.speaker or self.default_speaker()
        prompt_ids = self._prompt_ids(spk, mode, instruct_text)
        sentences = textutils.split_into_sentences(text)
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            tokens = self.streamer.stream(self.tokenizer.encode(sentence), prompt_ids,
                                          spk.speech_tokens, seed=si,
                                          speculative=self.speculative, gamma=self.gamma)
            flow_noise, hift_noise = self.noises(si)
            audio = self.synth.stream(tokens, spk.speech_tokens, spk.prompt_mel, spk.embedding,
                                      chunk_size=self.streamer.chunk, flow_noise=flow_noise,
                                      hift_noise=hift_noise)
            final = si == len(sentences) - 1
            if granularity == StreamingGranularity.TOKEN:
                for samples in audio:
                    self._check_stopped()
                    yield AudioChunk(samples=samples, sample_rate=self.sample_rate,
                                     text=sentence, is_final=False)
                if final:
                    yield AudioChunk(samples=np.zeros(0, np.float32),
                                     sample_rate=self.sample_rate, text=sentence, is_final=True)
            else:
                parts = list(audio)
                yield AudioChunk(samples=np.concatenate(parts) if parts
                                 else np.zeros(0, np.float32), sample_rate=self.sample_rate,
                                 text=sentence, is_final=final)
