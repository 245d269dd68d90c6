"""Whisper transcription pipeline (port of
tpu_audio/models/whisper/pipeline.py: MelExtractor, WhisperPipeline,
_pad_frames, _make_segment).

`WhisperPipeline` is the host seek loop over 30 s windows: content-aware
seek advance, temperature fallback on compression ratio / mean log-prob,
no-speech skipping, timestamp-pair segmentation and prompt conditioning on
the previous text, each window decoded by `decoding.SegmentDecoder`; with
`word_timestamps`, each window's segments get their words (`timing.py`),
and `hallucination_silence_threshold` drops anomalous segments between
silences. Batch transcription of fixed windows is in `batch.py`.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from tpu_audio_torch.api.results import TranscriptionResult, TranscriptionSegment
from tpu_audio_torch.models.whisper import timing
from tpu_audio_torch.models.whisper.decoding import DecodingResult, SegmentDecoder
from tpu_audio_torch.models.whisper.model import Whisper
from tpu_audio_torch.models.whisper.tokenizer import WhisperTokenizer
from tpu_audio_torch.ops import frontends
from tpu_audio_torch.ops.kernels import fused_mel

N_FRAMES = frontends.WHISPER_N_FRAMES  # 3000
HOP = frontends.WHISPER_HOP
N_FFT = frontends.WHISPER_N_FFT
CHUNK_SAMPLES = frontends.WHISPER_N_SAMPLES
SAMPLE_RATE = frontends.WHISPER_SAMPLE_RATE

_log = logging.getLogger("tpu_audio_torch.stt")


class MelExtractor:
    """Whole-clip log-mel, one `fused_log_mel` launch per clip.

    The clip, with an n_fft/2 sample reflect margin on each side and zeros
    to a whole number of 30 s chunks, goes through the kernel at once: frame
    j of chunk c is frame 3000·c + j of the one pass (the JAX package's
    chunks, each with its margins, give the same frames). The clip-wide
    max−8 clip and the (x+4)/4 normalisation follow (the clip is a global
    max in Whisper).
    """

    def __init__(self, n_mels: int, device: torch.device | str = "cuda"):
        self.n_mels = n_mels
        self.device = torch.device(device)

    def __call__(self, audio: np.ndarray,
                 padding: int = CHUNK_SAMPLES) -> torch.Tensor:
        """audio (T,) 16 kHz → normalized log-mel (total_frames, n_mels), f32
        on the extractor's device, total_frames = (T + padding) // HOP."""
        margin = N_FFT // 2
        total = len(audio) + padding
        total_frames = total // HOP
        padded = np.pad(np.asarray(audio, np.float32), (0, padding))
        padded = np.pad(padded, (margin, margin), mode="reflect")
        n_chunks = -(-total_frames // N_FRAMES)
        need = n_chunks * CHUNK_SAMPLES + 2 * margin
        if len(padded) < need:
            padded = np.pad(padded, (0, need - len(padded)))
        x = torch.from_numpy(padded[:need]).to(self.device)
        mel = fused_mel.fused_log_mel(x, n_mels=self.n_mels)
        return frontends.log10_norm(mel[:total_frames])


def _pad_frames(mel: torch.Tensor, n: int) -> torch.Tensor:
    if mel.shape[0] >= n:
        return mel[:n]
    return torch.nn.functional.pad(mel, (0, 0, 0, n - mel.shape[0]))


class WhisperPipeline:
    """transcribe / detect_language over a `Whisper` model. compute_dtype
    is the encoder's and the self-attention cache's dtype (f32, as in the
    JAX package, by default; bf16 on the card)."""

    def __init__(self, model: Whisper, tokenizer: WhisperTokenizer,
                 compute_dtype: torch.dtype = torch.float32, kv_int8: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.kv_int8 = kv_int8
        self.decoder = SegmentDecoder(model, tokenizer, compute_dtype, kv_int8=kv_int8)
        self.mel_extractor = MelExtractor(self.cfg.n_mels, device=model.device)

    # ---------------------------------------------------------------- public

    def detect_language(self, audio: np.ndarray) -> tuple[str, dict]:
        mel = self.mel_extractor(audio[:CHUNK_SAMPLES], padding=max(
            0, CHUNK_SAMPLES - len(audio)))[:N_FRAMES]
        return self.decoder.detect_language(_pad_frames(mel, N_FRAMES))

    def transcribe(
        self,
        audio: np.ndarray,
        *,
        language: str | None = None,
        task: str = "transcribe",
        temperature: tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: float | None = 2.4,
        logprob_threshold: float | None = -1.0,
        no_speech_threshold: float | None = 0.6,
        condition_on_previous_text: bool = True,
        timestamps: bool = True,
        word_timestamps: bool = False,
        hallucination_silence_threshold: float | None = None,
        initial_prompt: str | None = None,
        verbose: bool = False,
    ) -> TranscriptionResult:
        """audio: float32 mono at 16 kHz."""
        t_start = time.perf_counter()
        audio = np.asarray(audio, np.float32)
        duration = len(audio) / SAMPLE_RATE

        mel = self.mel_extractor(audio)
        content_frames = mel.shape[0] - N_FRAMES

        if language is None:
            if self.tok.multilingual:
                language, probs = self.decoder.detect_language(
                    _pad_frames(mel[:N_FRAMES], N_FRAMES))
                _log.info("detected language %s (p=%.2f)", language, probs[language])
            else:
                language = "en"

        tok = self.tok
        ts_begin = tok.timestamp_begin
        time_precision = 0.02  # seconds per timestamp token

        all_tokens: list[int] = []
        all_segments: list[TranscriptionSegment] = []
        prompt_reset_since = 0
        if initial_prompt:
            all_tokens.extend(tok.encode(" " + initial_prompt.strip()))

        seek = 0
        while seek < content_frames:
            time_offset = seek * HOP / SAMPLE_RATE
            mel_segment = _pad_frames(mel[seek: seek + N_FRAMES], N_FRAMES)
            segment_size = min(N_FRAMES, content_frames - seek)
            segment_duration = segment_size * HOP / SAMPLE_RATE

            prompt = (all_tokens[prompt_reset_since:][-223:]
                      if condition_on_previous_text else None) or None
            result = self._decode_with_fallback(
                mel_segment, language=language, task=task,
                temperature=temperature,
                compression_ratio_threshold=compression_ratio_threshold,
                logprob_threshold=logprob_threshold,
                prompt=prompt, timestamps=timestamps)

            if no_speech_threshold is not None:
                should_skip = result.no_speech_prob > no_speech_threshold
                if (logprob_threshold is not None
                        and result.avg_logprob > logprob_threshold):
                    should_skip = False  # confident despite no-speech flag
                if should_skip:
                    seek += segment_size
                    continue

            previous_seek = seek
            tokens = result.tokens
            ts_tokens = [t >= ts_begin for t in tokens]
            single_ts_ending = (len(tokens) >= 2 and not ts_tokens[-2]
                                and ts_tokens[-1])

            consecutive = [i + 1 for i in range(len(tokens) - 1)
                           if ts_tokens[i] and ts_tokens[i + 1]]
            segments_here = []
            if consecutive:
                # tokens after the final closed pair are dropped unless the
                # window ends on a single timestamp (openai-whisper behavior)
                slices = list(consecutive)
                if single_ts_ending:
                    slices.append(len(tokens))
                last_slice = 0
                for end_slice in slices:
                    sliced = tokens[last_slice:end_slice]
                    start_pos = sliced[0] - ts_begin
                    end_pos = sliced[-1] - ts_begin
                    segments_here.append(_make_segment(
                        tok, len(all_segments) + len(segments_here), seek,
                        time_offset + start_pos * time_precision,
                        time_offset + end_pos * time_precision,
                        sliced, result))
                    last_slice = end_slice
                if single_ts_ending:
                    seek += segment_size
                else:
                    last_ts_pos = tokens[last_slice - 1] - ts_begin
                    seek += last_ts_pos * 2  # frames are 2× timestamp steps
            else:
                dur = segment_duration
                ts = [t for t in tokens if t >= ts_begin]
                if ts and ts[-1] != ts_begin:
                    dur = (ts[-1] - ts_begin) * time_precision
                segments_here.append(_make_segment(
                    tok, len(all_segments), seek, time_offset,
                    time_offset + dur, tokens, result))
                seek += segment_size

            if word_timestamps and segments_here:
                timing.add_word_timestamps(
                    segments_here, model=self.model, tokenizer=tok, mel=mel_segment,
                    language=language, time_offset=time_offset, dtype=self.decoder.dtype)

            for seg in segments_here:
                all_tokens.extend(seg.tokens)
                all_segments.append(seg)
                if verbose:
                    _log.info("[%.2f -> %.2f] %s", seg.start, seg.end, seg.text)

            if not condition_on_previous_text or result.temperature > 0.5:
                prompt_reset_since = len(all_tokens)
            if seek <= previous_seek:  # safety: always make progress
                seek = previous_seek + segment_size

        if word_timestamps and hallucination_silence_threshold:
            all_segments = timing.filter_hallucinated_segments(
                all_segments, hallucination_silence_threshold, duration)

        text = "".join(s.text for s in all_segments).strip()
        processing = time.perf_counter() - t_start
        _log.info("whisper.transcribe: %.3f s for %.3f s of audio", processing, duration)
        return TranscriptionResult(
            text=text, segments=all_segments, language=language,
            duration=duration, processing_time=processing)

    # ---------------------------------------------------------------- internal

    def _decode_with_fallback(self, mel_segment, *, language, task, temperature,
                              compression_ratio_threshold, logprob_threshold,
                              prompt, timestamps) -> DecodingResult:
        result = None
        for t in temperature:
            result = self.decoder.decode(
                mel_segment, language=language, task=task, temperature=t,
                timestamps=timestamps, prompt=prompt, seed=int(t * 10))
            needs_fallback = False
            if (compression_ratio_threshold is not None
                    and result.compression_ratio > compression_ratio_threshold):
                needs_fallback = True
            if (logprob_threshold is not None
                    and result.avg_logprob < logprob_threshold):
                needs_fallback = True
            if not needs_fallback:
                return result
        return result


def _make_segment(tok, idx, seek, start, end, tokens, result) -> TranscriptionSegment:
    text_tokens = [t for t in tokens if t < tok.eot]
    return TranscriptionSegment(
        id=idx, seek=seek, start=start, end=end,
        text=tok.decode(text_tokens), tokens=tokens,
        temperature=result.temperature, avg_logprob=result.avg_logprob,
        compression_ratio=result.compression_ratio,
        no_speech_prob=result.no_speech_prob)
