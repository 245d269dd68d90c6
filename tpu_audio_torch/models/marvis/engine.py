"""Marvis TTS engine: frame-granularity streaming through Mimi (port of
tpu_audio/models/marvis/engine.py: MarvisEngine).

text → `split_into_sentences` → per sentence the prompt "[speaker]text" in
the last column of its frame rows, left-padded to a multiple of 32 → the
prefill (`frame_step` over the prompt) → spans of `frame_span` frames, each
frame fed back as the next input, until an all-zero frame (EOS) or
`max_frames` → Mimi at 24 kHz. Quality sets the codebooks a frame: low 8,
medium 16, high 24, max 32.

A span is a plain Python loop of frames on the device, read back to the
host once, and EOS is checked between spans, as in the JAX package (where
a span is one compiled scan). Where the whole-stack step serves a stack
(`transformer.fused_decode_supported`, a shape rule), each depth-decoder
token is one launch (32 a frame at "max": the first feeds the backbone's
state), and the backbone's one-token
frame step is one launch on its cache in the kernel's layout after the
prefill. The JAX package's environment switches that turn either off are
TPU ablation knobs and are not ported. At FRAME granularity each group of
`streaming_interval_tokens(0.5)` frames is decoded by the exact streaming
Mimi decoder (`codecs/mimi/streaming.py`); at SENTENCE granularity the
sentence is decoded whole, in buckets of 8 frames (Mimi is causal: the
zero codes of the bucket do not reach the real frames).

`load()` reads the checkpoint (`models/marvis/load.py`) onto `device`, the
card unless the caller asks for the CPU. `kv_quantized=True` keeps the
backbone's cache as int8 codes with per-token scales
(`ops/kvcache.QuantizedKVCache`): the backbone then runs layer by layer
over it (no whole-stack step), while the depth decoder keeps the
whole-stack step, as in the JAX engine. A 6-bit checkpoint, which neither
package can serve, is refused (ValueError).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from tpu_audio_torch.api.tts import AudioChunk, StreamingGranularity, TTSEngineBase
from tpu_audio_torch.codecs.mimi import model as mimi
from tpu_audio_torch.codecs.mimi import streaming
from tpu_audio_torch.convert import serving_dtype, tree_device
from tpu_audio_torch.models.marvis import model as mmodel
from tpu_audio_torch.models.marvis.load import refuse_q6
from tpu_audio_torch.nn import attention, transformer
from tpu_audio_torch.utils import constants
from tpu_audio_torch.utils import text as textutils
from tpu_audio_torch.utils.tokenizer import load_tokenizer

REPOS = {"100m": "Marvis-AI/marvis-tts-100m-v0.2-MLX-6bit",
         "250m": "Marvis-AI/marvis-tts-250m-v0.2-MLX-6bit"}
PROMPT_BUCKET = 32  # prompt rows are left-padded to a multiple
MIMI_BUCKET = 8     # frames; a sentence's codes are decoded in a multiple


class MarvisEngine(TTSEngineBase):
    sample_rate = 24000
    supported_streaming_granularities = (StreamingGranularity.SENTENCE,
                                         StreamingGranularity.FRAME)
    default_streaming_granularity = StreamingGranularity.FRAME

    def __init__(self, quality: str = "high", model: str = "250m", speaker: int = 0,
                 temperature: float = 0.9, top_k: int = 50, kv_quantized: bool = False,
                 frame_span: int | None = None, quantization: str | None = None,
                 device: torch.device | str = "cuda"):
        """quantization: None (the checkpoint's weights) or "w8a8" (the
        backbone and depth-decoder stacks requantised to per-channel int8).
        kv_quantized: the backbone's cache in int8. device: the card unless
        the caller asks for the CPU."""
        super().__init__()
        self.quality = quality
        self.model_size = model
        self.speaker = speaker
        self.temperature = temperature
        self.top_k = top_k
        self.kv_quantized = kv_quantized
        self.quantization = quantization
        self.device = device
        self.params = None
        self.cfg = mmodel.MarvisConfig()
        self.mimi_params = None
        self.mimi_cfg = mimi.MimiConfig()
        self.tokenizer = None
        self.max_frames = 512  # 40 s cap a sentence
        self._depth_fused = False  # the depth decoder through the whole-stack step
        self._bb_fused = False     # and the backbone's one-token frame step
        # frames a span: one host read a span, EOS checked between spans
        self.frame_span = frame_span or constants.streaming_interval_tokens(
            constants.DEFAULT_STREAMING_INTERVAL) or 6

    @property
    def n_codebooks(self) -> int:
        return min(constants.MARVIS_CODEBOOKS[self.quality], self.cfg.n_codebooks)

    def load(self, progress_handler=None) -> None:
        if self.is_loaded:
            return
        from tpu_audio_torch.models.marvis import load as mload

        (params, self.cfg, self.tokenizer, self.mimi_params,
         self.mimi_cfg) = mload.load(REPOS[self.model_size], serving_dtype(self.device),
                                     self.device)
        self.params = self._fuse(self._quantize(params, self.quantization))
        self._tune_cfg()
        self._depth_fused, self._bb_fused = self._fused_supported(
            self.cfg, self.params, self.kv_quantized, self.max_frames, self.frame_span)
        self.is_loaded = True

    @staticmethod
    def _fused_supported(cfg, params, kv_quantized: bool = False, max_frames: int = 512,
                         frame_span: int = 8) -> tuple[bool, bool]:
        """(depth, backbone): whether the whole-stack step serves the depth
        decoder at its ring and the backbone at its base bucket's ring, by
        the kernel's shape rule alone (on CUDA the kernel launches or
        raises; it takes any ring length)."""
        depth = transformer.fused_decode_supported(cfg.decoder, params["decoder"],
                                                   mmodel.depth_ring_len(cfg))
        bb = (depth and not kv_quantized and transformer.fused_decode_supported(
            cfg.backbone, params["backbone"],
            mmodel.backbone_ring_len(PROMPT_BUCKET, max_frames, frame_span)))
        return depth, bb

    @staticmethod
    def _quantize(params, quantization):
        """"w8a8": the backbone and depth-decoder stacks to fused per-channel
        int8 (group-affine checkpoint leaves requantised, fp leaves
        quantised); None keeps the tree. A 6-bit leaf raises either way."""
        refuse_q6(params, "marvis")
        if quantization is None:
            return params
        if quantization != "w8a8":
            raise ValueError(f"unsupported quantization {quantization!r}; "
                             "marvis serves bf16 or 'w8a8'")
        from tpu_audio_torch.ops import quant

        def q(tree):
            t = quant.requantize_tree_int8(tree, fuse=False)
            return quant.fuse_int8_tree(quant.quantize_tree_int8(t))

        return dict(params, backbone=q(params["backbone"]), decoder=q(params["decoder"]))

    def _tune_cfg(self):
        """A no-op: the JAX engine unrolls the depth decoder's layer scan;
        here the layers are a Python loop, with no scan to unroll."""

    @staticmethod
    def _fuse(params):
        """Fuse fp q/k/v and gate/up leaves of both stacks (quantised leaves
        arrive fused): fewer, larger products, and the whole-stack step's
        layout."""
        params = dict(params)
        for name in ("backbone", "decoder"):
            if name in params:
                params[name] = transformer.fuse_fp_tree(params[name])
        return params

    @classmethod
    def from_params(cls, params, cfg, mimi_params, mimi_cfg, tokenizer=None,
                    max_frames: int = 64, quantization: str | None = None,
                    kv_quantized: bool = False) -> "MarvisEngine":
        eng = cls(quantization=quantization, kv_quantized=kv_quantized)
        eng.params = cls._fuse(cls._quantize(params, quantization))
        eng.cfg = cfg
        eng._tune_cfg()
        eng.mimi_params = mimi_params
        eng.mimi_cfg = mimi_cfg
        eng.tokenizer = tokenizer or load_tokenizer(None)
        eng.max_frames = max_frames
        eng._depth_fused, eng._bb_fused = cls._fused_supported(
            eng.cfg, eng.params, eng.kv_quantized, eng.max_frames, eng.frame_span)
        eng.is_loaded = True
        return eng

    # ---------------------------------------------------------------- internals

    def _tokenize_text(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        """Frame rows of the text prompt: the ids in the last column."""
        k = self.cfg.n_codebooks
        ids = self.tokenizer.encode(f"[{self.speaker}]{text}")
        tokens = np.zeros((len(ids), k + 1), np.int64)
        tokens[:, -1] = ids
        mask = np.zeros((len(ids), k + 1), bool)
        mask[:, -1] = True
        return tokens, mask

    def _frame_input(self, frame: torch.Tensor):
        """The previous frame (1, k) as the next input: (tokens, mask)
        (1, 1, K+1), the codebooks past k and the text column zero and
        masked."""
        kk = self.cfg.n_codebooks
        tokens = torch.zeros((1, 1, kk + 1), dtype=torch.int64, device=frame.device)
        tokens[0, 0, :frame.shape[-1]] = frame[0]
        mask = torch.zeros((1, 1, kk + 1), dtype=torch.bool, device=frame.device)
        mask[0, 0, :frame.shape[-1]] = True
        return tokens, mask

    def _prefill(self, tokens, mask, pad: int, s_max: int, k: int, gen):
        """The prompt through the backbone and one frame: (frame (1, k),
        cache, extra mask hiding the pad slots)."""
        dev = tokens.device
        cache = transformer.make_cache(self.cfg.backbone, 1, s_max, dtype=torch.float32,
                                       quantized=self.kv_quantized, device=dev)
        slot = torch.arange(s_max, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        extra = torch.where(slot >= pad, zero, attention.NEG_INF)[None, None, None, :]
        frame, cache = mmodel.frame_step(
            self.params, self.cfg, tokens, mask, cache, max_codebooks=k,
            temperature=self.temperature, top_k=self.top_k, extra_mask=extra,
            depth_fused=self._depth_fused, generator=gen)
        return frame, cache, extra

    def _span(self, frame, state, extra, span: int, k: int, gen):
        """`span` frames, each fed the one before: (frames (span, 1, k) on
        the device, the last frame). `state` is the backbone's KVCache, or
        with the fused backbone [kc, vc, pos, start] in the kernel's layout;
        either is advanced in place."""
        frames = []
        for _ in range(span):
            tokens, mask = self._frame_input(frame)
            if isinstance(state, list):
                kc, vc, pos, start = state
                frame, _, _ = mmodel.frame_step_fused_bb(
                    self.params, self.cfg, tokens, mask, kc, vc, pos, start, max_codebooks=k,
                    temperature=self.temperature, top_k=self.top_k, generator=gen)
                pos += 1
            else:
                frame, _ = mmodel.frame_step(
                    self.params, self.cfg, tokens, mask, state, max_codebooks=k,
                    temperature=self.temperature, top_k=self.top_k, extra_mask=extra,
                    depth_fused=self._depth_fused, generator=gen)
            frames.append(frame)
        return torch.stack(frames), frame

    def _stream_dec_fn(self, chunk: int, k: int):
        """The exact streaming Mimi decode of a stream in chunks of ≤ `chunk`
        frames of k codebooks: a function (k, F) codes → F · hop samples,
        its decoder state carried across calls."""
        dev = tree_device(self.mimi_params)
        state = streaming.init_state(self.mimi_params, self.mimi_cfg, 1, chunk)

        def decode(codes: np.ndarray) -> np.ndarray:
            x = torch.as_tensor(codes[:k], dtype=torch.int64, device=dev)[None]
            audio, _ = streaming.decode_stream(self.mimi_params, self.mimi_cfg, x, state)
            return audio[0].float().cpu().numpy()
        return decode

    @torch.inference_mode()
    def _decode_frames(self, frames: np.ndarray) -> np.ndarray:
        """(T, k) codes → audio, decoded in a bucket of MIMI_BUCKET frames
        (code 0 after the last) and cut to T · hop samples."""
        t = frames.shape[0]
        if t == 0:
            return np.zeros(0, np.float32)
        bucket = -(-t // MIMI_BUCKET) * MIMI_BUCKET
        codes = np.zeros((1, frames.shape[1], bucket), np.int64)
        codes[0, :, :t] = frames.T
        codes = torch.as_tensor(codes, device=tree_device(self.mimi_params))
        audio = mimi.decode(self.mimi_params, self.mimi_cfg, codes)
        return audio[0, : t * self.mimi_cfg.hop].float().cpu().numpy()

    # ---------------------------------------------------------------- synthesis

    @torch.inference_mode()
    def generate_streaming(self, text: str, granularity: StreamingGranularity | None = None,
                           **kw) -> Iterator[AudioChunk]:
        if self.params is None:
            self.load()
        granularity = granularity or self.default_streaming_granularity
        if granularity not in self.supported_streaming_granularities:
            raise ValueError(f"Marvis streams by sentence or frame, not {granularity}")
        k = self.n_codebooks
        stream_frames = constants.streaming_interval_tokens(
            constants.DEFAULT_STREAMING_INTERVAL) or 6
        span = self.frame_span
        dev = tree_device(self.params)
        streamed = granularity == StreamingGranularity.FRAME
        sentences = textutils.split_into_sentences(text)
        for si, sentence in enumerate(sentences):
            self._check_stopped()
            tokens, mask = self._tokenize_text(sentence)
            n = tokens.shape[0]
            pad = -(-n // PROMPT_BUCKET) * PROMPT_BUCKET
            tok_pad = np.zeros((1, pad, tokens.shape[1]), np.int64)
            mask_pad = np.zeros((1, pad, tokens.shape[1]), bool)
            tok_pad[0, pad - n:] = tokens
            mask_pad[0, pad - n:] = mask
            gen = torch.Generator(device=dev).manual_seed(si)
            s_max = mmodel.backbone_ring_len(pad, self.max_frames, span)
            frame, cache, extra = self._prefill(torch.as_tensor(tok_pad, device=dev),
                                                torch.as_tensor(mask_pad, device=dev),
                                                pad - n, s_max, k, gen)
            state = cache
            if self._bb_fused:
                kc, vc, pos = mmodel.cache_to_fused(
                    cache, mmodel.fused_cache_dtype(dev, cache.k.dtype))
                state = [kc, vc, pos, torch.tensor(pad - n, dtype=torch.int64, device=dev)]
            decode = self._stream_dec_fn(stream_frames, k) if streamed else None
            frames, pending = [], []
            span_host = [frame[0].cpu().numpy()]
            done = False
            while True:
                self._check_stopped()
                for f in span_host:
                    if not f.any():  # the all-zero frame: EOS
                        done = True
                        break
                    frames.append(f)
                    pending.append(f)
                    if streamed and len(pending) >= stream_frames:
                        audio = decode(np.stack(pending).T)
                        pending = []
                        yield AudioChunk(samples=audio, sample_rate=self.sample_rate,
                                         text=sentence, is_final=False)
                    if len(frames) >= self.max_frames:
                        done = True
                        break
                if done:
                    break
                nxt, frame = self._span(frame, state, extra, span, k, gen)
                span_host = list(nxt[:, 0].cpu().numpy())  # one host read a span
            if streamed:
                # the last partial group: padded to the chunk, its samples kept
                audio = np.zeros(0, np.float32)
                if pending:
                    codes = np.zeros((k, stream_frames), np.int64)
                    codes[:, :len(pending)] = np.stack(pending).T
                    audio = decode(codes)[: len(pending) * self.mimi_cfg.hop]
            else:
                audio = (self._decode_frames(np.stack(frames)) if frames
                         else np.zeros(0, np.float32))
            yield AudioChunk(samples=audio, sample_rate=self.sample_rate, text=sentence,
                             is_final=si == len(sentences) - 1)
