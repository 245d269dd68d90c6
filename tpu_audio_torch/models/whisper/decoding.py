"""Whisper segment decoding (port of tpu_audio/models/whisper/decoding.py:
NEG_INF, MAX_INITIAL_TIMESTAMP_INDEX, DecodingResult, compression_ratio,
build_suppress_mask, build_blank_mask, SegmentDecoder).

`SegmentDecoder` decodes one 30 s window at B=1. The JAX package compiles
the whole segment (encode, prefill, suppression masks, timestamp rules,
the timestamp-probability heuristic, sampling, the stop at end of text)
into one `while_loop`; here the loop runs eagerly with every piece of its
state on the device, as in `batch.py`, and the host reads `finished` once
every `SYNC_EVERY` steps. Steps run after end of text write `eot` and add
no log-prob, so they change nothing. Over an int8 cross-K/V state each
step is one launch of the whole-decoder kernel plus the lm head.

Timestamp rules follow openai-whisper's ApplyTimestampRules:
  - <|notimestamps|> suppressed; the first generated token is a timestamp
    (≤ max_initial_timestamp index 50)
  - after a timestamp pair: all timestamps suppressed; after text +
    timestamp: text suppressed (pairs must close)
  - timestamps never decrease
  - if sum p(timestamps) > max p(text): force a timestamp

Sampling at temperature T > 0 takes argmax(logits / T + g) with g standard
Gumbel noise, which is how `jax.random.categorical` samples; g comes from
`SegmentDecoder.gumbel`, a `torch.Generator` seeded by `seed`, which a
test can replace to feed both packages the same noise.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.models.whisper.model import Whisper
from tpu_audio_torch.models.whisper.tokenizer import WhisperTokenizer

NEG_INF = float(np.finfo(np.float32).min)
MAX_INITIAL_TIMESTAMP_INDEX = 50
SYNC_EVERY = 8  # decode steps between host reads of the `finished` flags


@dataclass
class DecodingResult:
    tokens: list = field(default_factory=list)
    text: str = ""
    avg_logprob: float = 0.0
    no_speech_prob: float = 0.0
    temperature: float = 0.0
    compression_ratio: float = 0.0


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def build_suppress_mask(tok: WhisperTokenizer, n_vocab: int) -> np.ndarray:
    """Static (V,) additive mask for always-suppressed tokens."""
    mask = np.zeros(n_vocab, np.float32)
    ids = list(tok.non_speech_tokens) + [
        tok.transcribe, tok.translate, tok.sot, tok.sot_prev, tok.sot_lm,
        tok.no_speech,
    ]
    for t in ids:
        if t < n_vocab:
            mask[t] = NEG_INF
    return mask


def build_blank_mask(tok: WhisperTokenizer, n_vocab: int) -> np.ndarray:
    """Extra first-step mask: blank and EOT suppressed."""
    mask = np.zeros(n_vocab, np.float32)
    for t in tok.encode(" ") + [tok.eot]:
        mask[t] = NEG_INF
    return mask


def gumbel(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n,) f32 standard Gumbel noise, -log(-log(u)) with u uniform in
    [tiny, 1), drawn from `generator` on its device."""
    u = torch.rand(n, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class SegmentDecoder:
    """Decodes one mel window at a time: greedy or sampled, with the
    timestamp rules, the no-speech probability and the mean log-prob."""

    def __init__(self, model: Whisper, tokenizer: WhisperTokenizer,
                 compute_dtype: torch.dtype = torch.float32, kv_int8: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.dtype = compute_dtype
        self.kv_int8 = kv_int8
        self.device = model.device
        self.suppress_mask = torch.from_numpy(
            build_suppress_mask(tokenizer, self.cfg.n_vocab)).to(self.device)
        self.blank_mask = torch.from_numpy(
            build_blank_mask(tokenizer, self.cfg.n_vocab)).to(self.device)
        self.gumbel = gumbel        # the sampler's noise: gumbel(generator, n)
        self._masks: dict = {}      # (n_init, timestamps, sot_index) → masks
        self._vocab = torch.arange(self.cfg.n_vocab, device=self.device)

    def _step_masks(self, key: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """(mask of every step after the first, mask of the first step): the
        static suppression, and on the first step the blank/EOT suppression
        and the initial-timestamp window."""
        if key not in self._masks:
            _, timestamps, _ = key
            ts_begin = self.tok.timestamp_begin
            base = self.suppress_mask.clone()
            if timestamps:
                base[self.tok.no_timestamps] = NEG_INF
            first = base + self.blank_mask
            if timestamps:
                first[:ts_begin] = NEG_INF
                first[ts_begin + MAX_INITIAL_TIMESTAMP_INDEX + 1:] = NEG_INF
            self._masks[key] = base, first
        return self._masks[key]

    def _timestamp_rules(self, logits, mask, last, second, last_ts, i: int):
        """The mask of step i ≥ 1 with the pair, monotonicity and
        probability rules applied."""
        tok, vocab = self.tok, self._vocab
        ts_begin, eot = tok.timestamp_begin, tok.eot
        last_was = last >= ts_begin
        penult_was = second >= ts_begin if i >= 2 else torch.ones_like(last_was)
        ts_mask = torch.zeros_like(mask)
        ts_mask = torch.where(last_was & penult_was & (vocab >= ts_begin), NEG_INF, ts_mask)
        ts_mask = torch.where(last_was & ~penult_was & (vocab < eot), NEG_INF, ts_mask)
        cutoff = last_ts + torch.where(last_was & ~penult_was, 0, 1)
        ts_mask = torch.where((last_ts >= 0) & (vocab >= ts_begin) & (vocab < cutoff),
                              NEG_INF, ts_mask)
        # the heuristic reads suppressed logits (openai-whisper applies
        # SuppressTokens before ApplyTimestampRules)
        logprobs = torch.log_softmax(logits + torch.minimum(mask, ts_mask), dim=-1)
        force = torch.logsumexp(logprobs[ts_begin:], dim=-1) > logprobs[:ts_begin].max()
        ts_mask = torch.where(force & (vocab < ts_begin), NEG_INF, ts_mask)
        return torch.minimum(mask, ts_mask)

    @torch.inference_mode()
    def _run(self, mel, init, key, temperature: float, seed: int):
        cfg, tok, model = self.cfg, self.tok, self.model
        n_init, timestamps, sot_index = key
        ts_begin, eot = tok.timestamp_begin, tok.eot
        base, first = self._step_masks(key)
        dev = self.device

        feats = model.encode(mel[None].to(self.dtype))
        state = model.init_state(feats, dtype=self.dtype, kv_int8=self.kv_int8)
        pre, state = model.decode_step(init[None], state)
        pre = pre.float()
        no_speech = torch.softmax(pre[0, sot_index], dim=-1)[tok.no_speech]

        generator = torch.Generator(device=dev).manual_seed(seed)
        max_gen = cfg.n_text_ctx - n_init
        buf = torch.full((max_gen,), eot, dtype=torch.int64, device=dev)
        last = init[-1]
        second = init[-2] if n_init >= 2 else torch.zeros((), dtype=torch.int64, device=dev)
        last_ts = torch.full((), -1, dtype=torch.int64, device=dev)
        finished = torch.zeros((), dtype=torch.bool, device=dev)
        sum_lp = torch.zeros((), dtype=torch.float32, device=dev)
        n_lp = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(max_gen):
            if i and i % SYNC_EVERY == 0 and bool(finished):
                break
            if i == 0:
                logits, mask = pre[0, -1], first
            else:
                lg, state = model.decode_step(last.view(1, 1), state)
                logits, mask = lg[0, -1].float(), base
                if timestamps:
                    mask = self._timestamp_rules(logits, mask, last, second, last_ts, i)
            masked = logits + mask
            if temperature == 0.0:
                nxt = masked.argmax()
            else:
                nxt = (masked / max(temperature, 1e-6)
                       + self.gumbel(generator, cfg.n_vocab)).argmax()
            nxt = torch.where(finished, eot, nxt)
            live = (nxt != eot) & ~finished
            lp = torch.log_softmax(masked, dim=-1).gather(0, nxt[None])[0]  # no host read
            sum_lp += torch.where(live, lp, 0.0)
            n_lp += live.to(torch.int32)
            buf[i] = nxt
            last_ts = torch.where(nxt >= ts_begin, nxt, last_ts)
            second, last = last, nxt
            finished = finished | (nxt == eot)
        return buf, sum_lp, n_lp, no_speech

    def decode(self, mel, *, language: str = "en", task: str = "transcribe",
               temperature: float = 0.0, timestamps: bool = True,
               prompt: list[int] | None = None, seed: int = 0) -> DecodingResult:
        """mel (3000, n_mels), a tensor or an array → the generated tokens
        (end of text dropped) and their statistics."""
        tok = self.tok
        tokens: list[int] = []
        if prompt:
            tokens.append(tok.sot_prev)
            tokens.extend(prompt)
        sot_index = len(tokens)
        tokens.extend(tok.sot_sequence(language, task))
        if not timestamps:
            tokens.append(tok.no_timestamps)
        key = (len(tokens), timestamps, sot_index)
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        init = torch.tensor(tokens, dtype=torch.int64, device=self.device)
        buf, sum_lp, n_lp, ns = self._run(mel, init, key, float(temperature), seed)
        out = buf.tolist()
        generated = out[:out.index(tok.eot)] if tok.eot in out else out
        text = tok.decode(generated)
        n = int(n_lp)
        return DecodingResult(
            tokens=generated, text=text,
            avg_logprob=float(sum_lp) / n if n else 0.0,
            no_speech_prob=float(ns), temperature=temperature,
            compression_ratio=compression_ratio(text))

    @torch.inference_mode()
    def detect_language(self, mel) -> tuple[str, dict[str, float]]:
        """One step over [sot] → the language probabilities."""
        tok, cfg, model = self.tok, self.cfg, self.model
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        feats = model.encode(mel[None].to(self.dtype))
        state = model.init_state(feats, dtype=self.dtype, kv_int8=self.kv_int8)
        sot = torch.tensor([[tok.sot]], dtype=torch.int64, device=self.device)
        logits, _ = model.decode_step(sot, state)
        mask = torch.full((cfg.n_vocab,), NEG_INF, device=self.device)
        mask[sorted(tok.language_tokens.values())] = 0.0
        probs = torch.softmax(logits[0, -1].float() + mask, dim=-1).cpu().numpy()
        by_lang = {lang: float(probs[tid]) for lang, tid in tok.language_tokens.items()}
        return max(by_lang, key=by_lang.get), by_lang
