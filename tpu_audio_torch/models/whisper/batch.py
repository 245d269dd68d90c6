"""Batched Whisper decoding: many 30 s windows through one decode loop
(port of tpu_audio/models/whisper/batch.py: BatchSegmentDecoder,
transcribe_windows).

B windows decode together with per-row suppression and timestamp state,
per-row end of text and shared weights. The JAX package runs the loop as
one compiled `while_loop`; here it runs eagerly, with every piece of loop
state (tokens, masks, log-prob sums, `finished` flags, the KV cache and its
position) on the device. No logits go to the host; the host reads
`finished.all()` once every `SYNC_EVERY` steps to stop early. A row that
has finished writes `eot` and adds no log-prob, so the steps run after
every row finished change nothing: the result equals the JAX loop's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_audio_torch.models.whisper.decoding import (NEG_INF,
                                                     MAX_INITIAL_TIMESTAMP_INDEX,
                                                     SYNC_EVERY, DecodingResult,
                                                     build_blank_mask,
                                                     build_suppress_mask,
                                                     compression_ratio)
from tpu_audio_torch.models.whisper.model import Whisper
from tpu_audio_torch.models.whisper.pipeline import (MelExtractor, N_FRAMES,
                                                     _pad_frames)
from tpu_audio_torch.models.whisper.tokenizer import WhisperTokenizer


class BatchSegmentDecoder:
    """Greedy/temperature decode of B mel windows at once."""

    def __init__(self, model: Whisper, tokenizer: WhisperTokenizer,
                 batch_size: int = 8, compute_dtype: torch.dtype = torch.bfloat16,
                 kv_int8: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.batch_size = batch_size
        self.dtype = compute_dtype
        self.kv_int8 = kv_int8
        self.device = model.device
        self.suppress_mask = torch.from_numpy(
            build_suppress_mask(tokenizer, self.cfg.n_vocab)).to(self.device)
        self.blank_mask = torch.from_numpy(
            build_blank_mask(tokenizer, self.cfg.n_vocab)).to(self.device)

    @torch.inference_mode()
    def _run(self, mels: torch.Tensor, init_tokens: torch.Tensor,
             timestamps: bool, temperature: float, generator: torch.Generator):
        cfg, tok, model = self.cfg, self.tok, self.model
        b, n_init = init_tokens.shape
        ts_begin, eot = tok.timestamp_begin, tok.eot
        v = cfg.n_vocab
        dev = self.device
        max_gen = cfg.n_text_ctx - n_init
        base_mask = self.suppress_mask.clone()
        if timestamps:
            base_mask[tok.no_timestamps] = NEG_INF
        vocab_idx = torch.arange(v, device=dev)

        feats = model.encode(mels.to(self.dtype))
        state = model.init_state(feats, batch=b, dtype=self.dtype,
                                 kv_int8=self.kv_int8)
        pre_logits, state = model.decode_step(init_tokens, state)
        pre_logits = pre_logits.float()
        no_speech = torch.softmax(
            pre_logits[:, n_init - len(tok.sot_sequence())], dim=-1)[:, tok.no_speech]

        buf = torch.full((b, max_gen), eot, dtype=torch.int64, device=dev)
        last = init_tokens[:, -1]
        second = (init_tokens[:, -2] if n_init >= 2
                  else torch.zeros(b, dtype=torch.int64, device=dev))
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        sum_lp = torch.zeros(b, dtype=torch.float32, device=dev)
        n_lp = torch.zeros(b, dtype=torch.int32, device=dev)
        last_ts = torch.full((b,), -1, dtype=torch.int64, device=dev)
        false = torch.zeros(b, dtype=torch.bool, device=dev)

        for i in range(max_gen):
            if i and i % SYNC_EVERY == 0 and bool(finished.all()):
                break
            if i == 0:
                logits = pre_logits[:, -1]
                mask = (base_mask + self.blank_mask)[None]
            else:
                lg, state = model.decode_step(last[:, None], state)
                logits = lg[:, -1].float()
                mask = base_mask[None]

            if timestamps:
                last_was = (last >= ts_begin) if i >= 1 else false
                penult_was = ~false if i < 2 else (second >= ts_begin)
                tsm = torch.zeros((b, v), dtype=torch.float32, device=dev)
                tsm = torch.where((last_was & penult_was)[:, None]
                                  & (vocab_idx >= ts_begin)[None], NEG_INF, tsm)
                tsm = torch.where((last_was & ~penult_was)[:, None]
                                  & (vocab_idx < eot)[None], NEG_INF, tsm)
                cutoff = last_ts + torch.where(last_was & ~penult_was, 0, 1)
                tsm = torch.where((last_ts >= 0)[:, None]
                                  & (vocab_idx[None] >= ts_begin)
                                  & (vocab_idx[None] < cutoff[:, None]),
                                  NEG_INF, tsm)
                if i == 0:
                    tsm[:, :ts_begin] = NEG_INF
                    tsm[:, ts_begin + MAX_INITIAL_TIMESTAMP_INDEX + 1:] = NEG_INF
                # heuristic on suppressed logits (openai-whisper filter
                # order: SuppressTokens before ApplyTimestampRules)
                logprobs = torch.log_softmax(logits + torch.minimum(mask, tsm), dim=-1)
                ts_lp = torch.logsumexp(logprobs[:, ts_begin:], dim=-1)
                max_text = logprobs[:, :ts_begin].amax(dim=-1)
                if i > 0:
                    force = ts_lp > max_text
                    tsm = torch.where(force[:, None] & (vocab_idx < ts_begin)[None],
                                      NEG_INF, tsm)
                mask = torch.minimum(mask, tsm)

            masked = logits + mask
            if temperature == 0.0:
                tok_next = masked.argmax(dim=-1)
            else:
                probs = torch.softmax(masked / max(temperature, 1e-6), dim=-1)
                tok_next = torch.multinomial(probs, 1, generator=generator)[:, 0]
            tok_next = torch.where(finished, eot, tok_next)

            lp = torch.log_softmax(masked, dim=-1).gather(1, tok_next[:, None])[:, 0]
            not_eot = (tok_next != eot) & ~finished
            sum_lp += torch.where(not_eot, lp, 0.0)
            n_lp += not_eot.to(torch.int32)
            buf[:, i] = tok_next
            last_ts = torch.where(tok_next >= ts_begin, tok_next, last_ts)
            second, last = last, tok_next
            finished = finished | (tok_next == eot)
        return buf, sum_lp, n_lp, no_speech

    def decode_batch(self, mels, *, language: str = "en",
                     task: str = "transcribe", temperature: float = 0.0,
                     timestamps: bool = True, seed: int = 0
                     ) -> list[DecodingResult]:
        """mels (B, 3000, n_mels), a tensor or an array → per-window
        DecodingResults. `seed` seeds the sampler's torch.Generator."""
        tok = self.tok
        if mels.shape[0] != self.batch_size:
            raise ValueError(f"expected {self.batch_size} windows, got {mels.shape[0]}")
        tokens = tok.sot_sequence(language, task)
        if not timestamps:
            tokens = tokens + [tok.no_timestamps]
        init = torch.tensor([tokens] * self.batch_size, dtype=torch.int64,
                            device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        mels = torch.as_tensor(mels, dtype=torch.float32, device=self.device)
        buf, sum_lp, n_lp, ns = (t.cpu().numpy() for t in self._run(
            mels, init, timestamps, float(temperature), generator))
        results = []
        for r in range(self.batch_size):
            toks = []
            for t in buf[r]:
                if t == tok.eot:
                    break
                toks.append(int(t))
            text = tok.decode(toks)
            n = int(n_lp[r])
            results.append(DecodingResult(
                tokens=toks, text=text,
                avg_logprob=float(sum_lp[r]) / n if n else 0.0,
                no_speech_prob=float(ns[r]), temperature=temperature,
                compression_ratio=compression_ratio(text)))
        return results


def transcribe_windows(model: Whisper, tokenizer: WhisperTokenizer,
                       audios: list[np.ndarray], batch_size: int = 8, *,
                       kv_int8: bool = False, return_results: bool = False,
                       **kw):
    """Fixed-stride batch transcription of many clips: split each clip into
    30 s windows, decode all windows in batches (bf16 compute), reassemble
    per clip.

    Returns one text per clip; with return_results=True, (texts, the
    DecodingResult of every window in order). Other keywords go to
    `BatchSegmentDecoder.decode_batch`."""
    extractor = MelExtractor(model.cfg.n_mels, device=model.device)
    decoder = BatchSegmentDecoder(model, tokenizer, batch_size, kv_int8=kv_int8)

    windows, owners = [], []
    for ci, audio in enumerate(audios):
        mel = extractor(np.asarray(audio, np.float32))
        content = mel.shape[0] - N_FRAMES
        for seek in range(0, max(content, 1), N_FRAMES):
            windows.append(_pad_frames(mel[seek: seek + N_FRAMES], N_FRAMES))
            owners.append(ci)

    texts = [[] for _ in audios]
    results = []
    for start in range(0, len(windows), batch_size):
        group = windows[start: start + batch_size]
        n_real = len(group)
        group = group + [torch.zeros_like(group[0])] * (batch_size - n_real)
        res = decoder.decode_batch(torch.stack(group), **kw)
        for j, r in enumerate(res[:n_real]):
            texts[owners[start + j]].append(r.text)
            results.append(r)
    texts = ["".join(t).strip() for t in texts]
    return (texts, results) if return_results else texts
