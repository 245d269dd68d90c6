"""Word-level timestamps: cross-attention alignment + DTW (port of
tpu_audio/models/whisper/timing.py: default_alignment_heads, median_filter,
dtw, split_tokens_on_unicode, split_tokens_on_spaces, find_alignment,
add_word_timestamps, _merge_punctuations_with_counts, word_anomaly_score,
is_segment_anomaly, filter_hallucinated_segments).

A full-sequence decoder pass over the window's tokens captures the raw
cross-attention scores (`Whisper.forward_cross_qk`, on the model's device);
the alignment heads are soft-maxed over the audio frames, standardised,
median-filtered and dynamic-time-warped on the host. Words are formed by
merging BPE tokens at unicode and space boundaries. The JAX module jits the
encode + cross-QK pass per token bucket; here it is one eager call.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_audio_torch.api.results import Word

AUDIO_TIME_PER_TOKEN = 0.02
MEDFILT_WIDTH = 7


def default_alignment_heads(cfg) -> list[tuple[int, int]]:
    """Without checkpoint metadata, use all heads of the top half of the
    decoder (openai-whisper's fallback)."""
    return [(layer, h) for layer in range(cfg.n_text_layer // 2, cfg.n_text_layer)
            for h in range(cfg.n_text_head)]


def median_filter(x: np.ndarray, width: int = MEDFILT_WIDTH) -> np.ndarray:
    """Median filter along the last axis with reflect padding."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.stack([xp[..., i: i + x.shape[-1]] for i in range(width)], axis=-1)
    return np.median(windows, axis=-1)


def dtw(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment path minimizing the sum of x (N tokens × M
    frames) → (text_indices, time_indices) along the traceback path. Ties
    prefer the diagonal, then the token step."""
    n, m = x.shape
    cost = np.full((n + 1, m + 1), np.inf, dtype=np.float64)
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    cost[0, 0] = 0.0
    for i in range(1, n + 1):
        row = x[i - 1]
        prev = cost[i - 1]
        cur = cost[i]
        for j in range(1, m + 1):
            c0, c1, c2 = prev[j - 1], prev[j], cur[j - 1]
            if c0 <= c1 and c0 <= c2:
                cur[j] = c0 + row[j - 1]
                trace[i, j] = 0
            elif c1 <= c2:
                cur[j] = c1 + row[j - 1]
                trace[i, j] = 1
            else:
                cur[j] = c2 + row[j - 1]
                trace[i, j] = 2
    i, j = n, m
    ti, tj = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(tj[::-1])


def split_tokens_on_unicode(tokenizer, tokens: list[int]):
    """Group BPE ids at valid-unicode boundaries."""
    replacement = "�"
    decoded_full = tokenizer.decode_with_timestamps(tokens)
    words, word_tokens = [], []
    current: list[int] = []
    unicode_offset = 0
    for t in tokens:
        current.append(t)
        decoded = tokenizer.decode_with_timestamps(current)
        if (replacement not in decoded or
                decoded_full[unicode_offset + decoded.index(replacement)] == replacement):
            words.append(decoded)
            word_tokens.append(current)
            current = []
            unicode_offset += len(decoded)
    return words, word_tokens


def split_tokens_on_spaces(tokenizer, tokens: list[int]):
    subwords, subword_tokens = split_tokens_on_unicode(tokenizer, tokens)
    words, word_tokens = [], []
    for sw, swt in zip(subwords, subword_tokens):
        special = swt[0] >= tokenizer.eot
        with_space = sw.startswith(" ")
        punctuation = sw.strip() in "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
        if special or with_space or punctuation or not words:
            words.append(sw)
            word_tokens.append(swt)
        else:
            words[-1] += sw
            word_tokens[-1].extend(swt)
    return words, word_tokens


def _softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=-1, keepdims=True)


@torch.inference_mode()
def _cross_qk(model, mel, tokens: list[int], dtype: torch.dtype):
    """Encode one window and run `forward_cross_qk` over the tokens:
    (logits (T, V), scores (L, 1, H, T, T_audio)) as f32 numpy."""
    mel = torch.as_tensor(mel, dtype=torch.float32, device=model.device)
    feats = model.encode(mel[None].to(dtype))
    ids = torch.tensor([tokens], dtype=torch.int64, device=model.device)
    logits, qks = model.forward_cross_qk(ids, feats)
    return logits[0].float().cpu().numpy(), qks.float().cpu().numpy()


def find_alignment(model, tokenizer, mel, text_tokens: list[int], language: str,
                   num_frames: int, alignment_heads: list[tuple[int, int]] | None = None,
                   dtype: torch.dtype = torch.float32) -> tuple[list[Word], list[int]]:
    """Align text tokens to audio frames for one 30 s window (mel (3000,
    n_mels), a tensor or an array, encoded in `dtype`).

    Returns (words, tokens_per_word) so callers can redistribute words to
    segments by token counts."""
    if not text_tokens:
        return [], []
    cfg = model.cfg
    heads = alignment_heads or default_alignment_heads(cfg)
    sot_seq = tokenizer.sot_sequence(language, "transcribe")
    tokens = [*sot_seq, tokenizer.no_timestamps, *text_tokens, tokenizer.eot]
    n = len(tokens)
    if n > cfg.n_text_ctx:
        raise ValueError(f"{n} alignment tokens exceed the decoder's {cfg.n_text_ctx} positions")
    logits, qks = _cross_qk(model, mel, tokens, dtype)

    # token probabilities for the sampled text tokens
    sampled_logits = logits[len(sot_seq): n - 1, : tokenizer.eot]
    probs = _softmax(sampled_logits)
    text_token_probs = [float(probs[i, t])
                        for i, t in enumerate(tokens[len(sot_seq) + 1: -1])]

    w = np.stack([qks[layer, 0, h] for layer, h in heads])  # (Hsel, T, T_audio)
    w = w[:, :, : num_frames // 2]
    w = _softmax(w)  # over frames
    mean = w.mean(axis=-2, keepdims=True)
    std = w.std(axis=-2, keepdims=True) + 1e-9
    w = (w - mean) / std
    w = median_filter(w, MEDFILT_WIDTH)
    matrix = w.mean(axis=0)
    matrix = matrix[len(sot_seq): -1]  # rows for generated tokens
    text_indices, time_indices = dtw(-matrix)

    words, word_tokens = split_tokens_on_spaces(tokenizer, text_tokens + [tokenizer.eot])
    if len(words) == 0:
        return [], []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] * AUDIO_TIME_PER_TOKEN
    if len(jump_times) <= word_boundaries[-1]:
        jump_times = np.pad(jump_times, (0, word_boundaries[-1] + 1 - len(jump_times)),
                            mode="edge")
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]

    # probabilities: mean over each word's token span
    spans = np.pad(np.cumsum([len(t) for t in word_tokens]), (1, 0))
    out, counts = [], []
    for i, (word, toks) in enumerate(zip(words, word_tokens)):
        if toks[0] >= tokenizer.eot:
            continue
        if i >= len(start_times):
            break
        p = (float(np.mean(text_token_probs[spans[i]: spans[i + 1]]))
             if spans[i] < len(text_token_probs) else 1.0)
        out.append(Word(word=word, start=float(start_times[i]), end=float(end_times[i]),
                        probability=p))
        counts.append(len(toks))
    return out, counts


def add_word_timestamps(segments, *, model, tokenizer, mel, language, time_offset,
                        dtype: torch.dtype = torch.float32,
                        prepend_punctuations="\"'“¿([{-",
                        append_punctuations="\"'.。,，!！?？:：”)]}、") -> None:
    """Attach Word lists to the window's segments in place."""
    if not segments:
        return
    text_tokens = [t for seg in segments for t in seg.tokens if t < tokenizer.eot]
    words, counts = find_alignment(model, tokenizer, mel, text_tokens, language,
                                   mel.shape[0], dtype=dtype)
    # punctuation merging can fuse words; track counts alongside
    merged = _merge_punctuations_with_counts(words, counts, prepend_punctuations,
                                             append_punctuations)

    # distribute words back to segments by cumulative TOKEN counts
    wi = 0
    consumed_tokens = 0
    boundary = 0
    for seg in segments:
        boundary += len([t for t in seg.tokens if t < tokenizer.eot])
        seg_words = []
        while wi < len(merged) and consumed_tokens < boundary:
            w, n_tok = merged[wi]
            seg_words.append(Word(word=w.word, start=round(time_offset + w.start, 3),
                                  end=round(time_offset + w.end, 3),
                                  probability=w.probability))
            consumed_tokens += n_tok
            wi += 1
        seg.words = seg_words
        if seg_words:
            seg.start = seg_words[0].start
            seg.end = seg_words[-1].end


def _merge_punctuations_with_counts(words: list[Word], counts: list[int],
                                    prepended: str, appended: str):
    """Fuse punctuation-only words into neighbors, summing token counts."""
    pairs = [[w, c] for w, c in zip(words, counts)]
    i = len(pairs) - 2
    while i >= 0:
        w = pairs[i][0]
        if w.word.startswith(" ") and w.word.strip() in prepended:
            pairs[i + 1][0] = Word(word=w.word + pairs[i + 1][0].word, start=w.start,
                                   end=pairs[i + 1][0].end,
                                   probability=pairs[i + 1][0].probability)
            pairs[i + 1][1] += pairs[i][1]
            pairs[i][1] = 0
        i -= 1
    pairs = [p for p in pairs if p[1] > 0 or p[0].word]
    out = []
    for w, c in pairs:
        if out and w.word in appended:
            pw, pc = out[-1]
            out[-1] = (Word(word=pw.word + w.word, start=pw.start, end=w.end,
                            probability=pw.probability), pc + c)
        elif c > 0:
            out.append((w, c))
    return out


# ---------------------------------------------------------------- anomaly
# Hallucination detection (WhisperTiming.swift:1010-1200 behavior, itself
# matching openai-whisper's word_anomaly_score / is_segment_anomaly).

_PUNCT = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
_CHUNK_LENGTH = 30.0


def word_anomaly_score(word: Word) -> float:
    """Anomalous words are very long, very short, or low-probability."""
    duration = word.end - word.start
    score = 0.0
    if word.probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def is_segment_anomaly(words: list[Word] | None) -> bool:
    """First 8 non-punctuation words scoring >= 3 (or ~all anomalous)."""
    if not words:
        return False
    filtered = [w for w in words if w.word not in _PUNCT][:8]
    if not filtered:
        return False
    score = sum(word_anomaly_score(w) for w in filtered)
    return score >= 3 or score + 0.01 >= len(filtered)


def filter_hallucinated_segments(segments, threshold: float, audio_duration: float) -> list:
    """Drop anomalous segments surrounded by silence (threshold seconds)."""
    if not threshold or not segments:
        return list(segments)

    def next_words_segment(start):
        for s in segments[start:]:
            if s.words:
                return s
        return None

    out = []
    last_speech = 0.0
    for i, seg in enumerate(segments):
        if not seg.words:
            out.append(seg)
            continue
        if is_segment_anomaly(seg.words):
            window_idx = int(seg.start / _CHUNK_LENGTH)
            time_offset = window_idx * _CHUNK_LENGTH
            window_end = min((window_idx + 1) * _CHUNK_LENGTH, audio_duration)
            nxt = next_words_segment(i + 1)
            hal_next_start = nxt.words[0].start if nxt else time_offset + _CHUNK_LENGTH
            silence_before = (seg.start - last_speech > threshold
                              or seg.start < threshold
                              or seg.start - time_offset < 2.0)
            silence_after = (hal_next_start - seg.end > threshold
                             or is_segment_anomaly(nxt.words if nxt else None)
                             or window_end - seg.end < 2.0)
            if silence_before and silence_after:
                continue
        out.append(seg)
        if seg.words:
            last_speech = seg.words[-1].end
    return out
