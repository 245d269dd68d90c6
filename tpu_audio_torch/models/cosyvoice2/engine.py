"""CosyVoice2 engine: zero-shot cloning, cross-lingual, instruct and voice
conversion over the Qwen2 LM, S3Gen and the S3 tokenizer (port of
tpu_audio/models/cosyvoice2/engine.py: SR_OUT, SR_TOK, ENDOFPROMPT,
CosyVoice2Speaker, CosyVoice2Engine).

`prepare_conditionals` makes a reusable speaker from reference audio: the
prompt text's ids, its S3 speech tokens (16 kHz log-mel → the tokenizer),
its S3Gen mel (24 kHz, two frames a token) and its CAMPPlus x-vector (Kaldi
fbank, mean-normalised). Without one the default speaker (four tokens,
zero mel and x-vector) serves. `generate` runs the sentence path: the LM's
whole sentence, then one `token2wav` pass bucketed to 25 tokens and a
20 ms fade-in. `generate_streaming` defaults to TOKEN granularity: LM
chunks of 25 tokens (+3 of lookahead in the first) → `CV2Synthesizer`'s
flow window → the windowed HiFT; the first chunk faded in.

`load()` reads the 4-bit checkpoint (`models/cosyvoice2/load.py`) onto
`device` (the card unless the caller asks for the CPU) and serves the LM
as per-channel int8 ("w8a8", the default: the whole-stack step kernel and
the int8 speech head), W4A8 ("w4a8"), as it is ("q4"), or dequantised to
bf16 ("bf16"), fp16 ("fp16") or the device's serving dtype ("none"). The
JAX engine takes the three fp names but serves the 4-bit tree as it is
under them (ROADMAP C35). `from_params`
takes built trees; its LM cache is sized for each request, where the JAX
engine's `max_cache=512` clamps a 30-token sentence's 600-odd slots
(ROADMAP C18). `speculative="ngram"` decodes the LM by prompt-lookup
speculative decoding, on the sentence path and in the token stream's
spans (`lm.CosyLMStreamer`). `mesh=` (a `parallel.make_mesh` DeviceMesh
with a "tp" axis) needs an fp LM, as in the JAX engine: the LM is served
tensor-parallel (`lm.CosyLMGenerator`), and the flow's conformer and CFM
estimator by local shards under `parallel.flow_rules`
(`parallel.shardings.local_tree`, heads by `s3gen.tp_config`); HiFT,
CAMPPlus and the tokenizer stay whole on every rank. The
Whisper auto-transcription of a reference without `ref_text` needs its
checkpoint.
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
from tpu_audio_torch.convert import serving_dtype, tree_device
from tpu_audio_torch.models.cosyvoice2 import lm as lm_mod
from tpu_audio_torch.ops import frontends
from tpu_audio_torch.ops.resample import resample
from tpu_audio_torch.parallel import tp_quant
from tpu_audio_torch.parallel.shardings import flow_rules, local_tree
from tpu_audio_torch.utils import text as textutils
from tpu_audio_torch.utils.tokenizer import load_tokenizer

SR_OUT = 24000
SR_TOK = 16000
ENDOFPROMPT = "<|endofprompt|>"
FP_QUANTIZATIONS = ("bf16", "fp16", "none")
QUANTIZATIONS = ("w8a8", "w4a8", "q4") + FP_QUANTIZATIONS
TOKEN_BUCKET = 25  # token2wav pads the tokens to a multiple
MODES = ("zero_shot", "cross_lingual", "instruct")


def fp_lm(lm_params: dict, quantization: str, device) -> dict:
    """The checkpoint's LM dequantised for an fp quantization: bf16, fp16,
    or ("none") the device's serving dtype."""
    from tpu_audio_torch.ops import quant

    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}.get(quantization,
                                                               serving_dtype(device))
    return quant.dequantize_tree(lm_params, dtype)


@dataclass
class CosyVoice2Speaker:
    prompt_text: str
    prompt_text_ids: list[int]
    speech_tokens: list[int]
    prompt_mel: torch.Tensor  # (1, 2P, 80)
    embedding: torch.Tensor  # (1, 192)


class CosyVoice2Engine(TTSEngineBase):
    sample_rate = SR_OUT
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,
                                         StreamingGranularity.TOKEN)
    default_streaming_granularity = StreamingGranularity.TOKEN

    def __init__(self, speed: float = 1.0, quantization: str = "w8a8", mesh=None,
                 speculative: str | None = None, gamma: int = 4,
                 device: torch.device | str = "cuda"):
        super().__init__()
        lm_mod.check_speculative(speculative)
        if quantization not in QUANTIZATIONS:
            raise ValueError(f"quantization must be one of {QUANTIZATIONS}, got {quantization!r}")
        if mesh is not None:
            tp_quant.tp_axis(mesh)  # refuses a non-mesh object, naming it
            if quantization not in FP_QUANTIZATIONS:
                raise ValueError(f"mesh serving needs an fp LM (quantization one of "
                                 f"{FP_QUANTIZATIONS}), got {quantization!r}")
        self.mesh = mesh
        self.speed = speed
        self.quantization = quantization
        self.speculative = speculative
        self.gamma = gamma
        self.device = device
        self.lm: lm_mod.CosyLMGenerator | None = None
        self.lm_cfg = lm_mod.CosyLMConfig()
        self.s3gen_params = None
        self.s3gen_cfg = s3gen.S3GenConfig()
        self.tok_params = None
        self.tok_cfg = s3tok.S3TokenizerConfig()
        self.tokenizer = None
        self.speaker: CosyVoice2Speaker | None = None
        self._whisper = None
        self._streamer: lm_mod.CosyLMStreamer | None = None
        self._synth = None

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.cosyvoice2 import load as cvload
        from tpu_audio_torch.ops import quant

        (lm_params, self.lm_cfg, self.s3gen_params, self.s3gen_cfg, self.tok_params,
         self.tok_cfg, self.tokenizer) = cvload.load(device=self.device)
        if self.quantization == "w8a8":
            lm_params = quant.requantize_tree_int8(lm_params)
        elif self.quantization == "w4a8":
            lm_params = quant.repack_tree_w4a8(lm_params)
        elif self.quantization in FP_QUANTIZATIONS:
            lm_params = fp_lm(lm_params, self.quantization, self.device)
        self.lm = lm_mod.CosyLMGenerator(lm_params, self.lm_cfg, mesh=self.mesh)
        self._shard_flow()
        self.is_loaded = True

    def _shard_flow(self) -> None:
        """Under a mesh: this rank's flow shards and local head counts."""
        if self.mesh is not None:
            self.s3gen_params = local_tree(self.s3gen_params, self.mesh, flow_rules)
            self.s3gen_cfg = s3gen.tp_config(self.s3gen_cfg, tp_quant.tp_axis(self.mesh)[2])

    @classmethod
    def from_params(cls, lm_params, lm_cfg, s3gen_params, s3gen_cfg, tok_params, tok_cfg,
                    tokenizer=None, max_cache: int | None = None,
                    mesh=None, speculative: str | None = None,
                    gamma: int = 4) -> "CosyVoice2Engine":
        """An engine over built trees (the LM bf16, int8, q4 or W4A8). The
        LM cache holds `max_cache` slots, or with None (the default) as
        many as each request needs. mesh: tensor-parallel serving of the
        LM and the flow, the engine's quantization "none", as in JAX."""
        eng = cls(quantization="none" if mesh is not None else "w8a8", mesh=mesh,
                  speculative=speculative, gamma=gamma, device=tree_device(s3gen_params))
        eng.lm_cfg = lm_cfg
        eng.lm = lm_mod.CosyLMGenerator(lm_params, lm_cfg, max_cache=max_cache, mesh=mesh)
        eng.s3gen_params, eng.s3gen_cfg = s3gen_params, s3gen_cfg
        eng._shard_flow()
        eng.tok_params, eng.tok_cfg = tok_params, tok_cfg
        eng.tokenizer = tokenizer or load_tokenizer(None)
        eng.is_loaded = True
        return eng

    # ---------------------------------------------------------------- speaker

    def _dev(self) -> torch.device:
        return tree_device(self.s3gen_params)

    def _auto_transcribe(self, audio16: np.ndarray) -> str:
        if self._whisper is None:
            from tpu_audio_torch.api.stt import STT

            self._whisper = STT.whisper("tiny", device=self.device)
        return self._whisper.transcribe(audio16).text.strip()

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
            ref_text = self._auto_transcribe(ref16)
        dev = self._dev()
        dt = self.s3gen_params["flow"]["input_embedding"]["weight"].dtype
        tokens = self.speech_tokens(ref16)
        mel = frontends.s3gen_mel(torch.as_tensor(ref24, dtype=torch.float32, device=dev),
                                  n_mels=self.s3gen_cfg.mel_dim).T[None]
        want = 2 * len(tokens)
        pm = mel[:, :want]
        if pm.shape[1] < want:
            pm = torch.nn.functional.pad(pm, (0, 0, 0, want - pm.shape[1]))
        fbank = frontends.kaldi_fbank(torch.as_tensor(ref16, dtype=torch.float32, device=dev))
        fbank = fbank - fbank.mean(dim=0, keepdim=True)
        emb = s3gen.embed_ref_mel(self.s3gen_params, self.s3gen_cfg, fbank[None].to(dt))
        self.speaker = CosyVoice2Speaker(
            prompt_text=ref_text, prompt_text_ids=self.tokenizer.encode(ref_text),
            speech_tokens=tokens, prompt_mel=pm.to(dt), embedding=emb)
        return self.speaker

    def default_speaker(self) -> CosyVoice2Speaker:
        dev = self._dev()
        return CosyVoice2Speaker(
            prompt_text="", prompt_text_ids=[], speech_tokens=[0, 1, 2, 3],
            prompt_mel=torch.zeros((1, 8, self.s3gen_cfg.mel_dim), device=dev),
            embedding=torch.zeros((1, self.s3gen_cfg.spk_dim), device=dev))

    # ---------------------------------------------------------------- modes

    @staticmethod
    def noises(seed: int):
        """(the flow's draws, HiFT's draws) of a request with this seed."""
        return Noise(seed), Noise(seed)

    @torch.inference_mode()
    def token2wav(self, tokens: list[int], spk: CosyVoice2Speaker, seed: int) -> np.ndarray:
        """One S3Gen pass over the tokens padded to a multiple of 25 (token
        0 after the last), cut to the generated samples and faded in."""
        n = len(tokens)
        if n == 0:
            return np.zeros(0, np.float32)
        dev = self._dev()
        bucket = -(-n // TOKEN_BUCKET) * TOKEN_BUCKET
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n] = torch.as_tensor(tokens)
        pt = torch.as_tensor(spk.speech_tokens, dtype=torch.int64, device=dev)[None]
        audio, start, valid = s3gen.token2wav(
            self.s3gen_params, self.s3gen_cfg, toks.to(dev), n, pt, pt.shape[1],
            spk.prompt_mel, spk.prompt_mel.shape[1], spk.embedding, *self.noises(seed))
        return s3gen.fade_in(audio[0, start: start + valid].float()).cpu().numpy()

    def _mode_ids(self, sentence: str, spk: CosyVoice2Speaker, mode: str,
                  instruct_text: str | None):
        """(prompt text ids, text ids, prompt speech tokens) of an LM call."""
        if mode == "zero_shot":
            prompt_ids = spk.prompt_text_ids
        elif mode == "cross_lingual":
            prompt_ids = []
        elif mode == "instruct":
            prompt_ids = self.tokenizer.encode((instruct_text or "") + ENDOFPROMPT)
        else:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        return prompt_ids, self.tokenizer.encode(sentence), spk.speech_tokens

    def _generate_sentence(self, sentence: str, spk: CosyVoice2Speaker, mode: str,
                           instruct_text: str | None, seed: int) -> np.ndarray:
        prompt_ids, text_ids, prompt_speech = self._mode_ids(sentence, spk, mode, instruct_text)
        tokens = self.lm.generate(text_ids, prompt_ids, prompt_speech, seed=seed,
                                  speculative=self.speculative, gamma=self.gamma)
        return self.token2wav(tokens, spk, seed)

    def voice_conversion(self, source_audio: np.ndarray, sample_rate: int,
                         speaker: CosyVoice2Speaker | None = None) -> np.ndarray:
        """The source speech's S3 tokens rendered with the speaker's flow
        conditioning."""
        spk = speaker or self.speaker or self.default_speaker()
        src16 = (resample(source_audio, sample_rate, SR_TOK) if sample_rate != SR_TOK
                 else np.asarray(source_audio, np.float32))
        if len(src16) < 640:  # shorter than one tokenizer frame
            return np.zeros(0, np.float32)
        with torch.inference_mode():
            tokens = self.speech_tokens(src16)
        return self.token2wav(tokens, spk, 0)

    # ---------------------------------------------------------------- synthesis

    def generate(self, text: str, **kw):
        """The whole text, by default sentence by sentence (one flow pass
        each, as the reference's non-streaming synthesis)."""
        kw.setdefault("granularity", StreamingGranularity.SENTENCE)
        return super().generate(text, **kw)

    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           mode: str = "zero_shot", instruct_text: str | None = None,
                           **kw) -> Iterator[AudioChunk]:
        if self.lm is None:
            self.load()
        spk = self.speaker or self.default_speaker()
        granularity = granularity or self.default_streaming_granularity
        sentences = textutils.split_into_sentences(text)
        if granularity == StreamingGranularity.TOKEN:
            yield from self._stream_tokens(sentences, spk, mode, instruct_text)
            return
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            audio = self._generate_sentence(sentence, spk, mode, instruct_text, si)
            yield AudioChunk(samples=audio, sample_rate=self.sample_rate, text=sentence,
                             is_final=si == len(sentences) - 1)

    def streamer(self) -> lm_mod.CosyLMStreamer:
        if self._streamer is None:
            self._streamer = lm_mod.CosyLMStreamer(
                self.lm, first_extra=self.s3gen_cfg.pre_lookahead_len)
        return self._streamer

    def synthesizer(self):
        from tpu_audio_torch.models.cosyvoice2.streaming import CV2Synthesizer

        if self._synth is None:
            self._synth = CV2Synthesizer(self.s3gen_params, self.s3gen_cfg)
        return self._synth

    def _stream_tokens(self, sentences: list[str], spk: CosyVoice2Speaker, mode: str,
                       instruct_text: str | None) -> Iterator[AudioChunk]:
        """LM chunks → the flow window → the windowed vocoder; the first
        audio after ~25 tokens instead of the whole first sentence."""
        streamer, synth = self.streamer(), self.synthesizer()
        pending: AudioChunk | None = None
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            prompt_ids, text_ids, prompt_speech = self._mode_ids(sentence, spk, mode,
                                                                 instruct_text)
            tokens = streamer.stream(text_ids, prompt_ids, prompt_speech, seed=si,
                                     speculative=self.speculative, gamma=self.gamma)
            first = True
            flow_noise, hift_noise = self.noises(si)
            for audio in synth.stream(tokens, spk.speech_tokens, spk.prompt_mel, spk.embedding,
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
