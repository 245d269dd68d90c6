"""Generic autoregressive decode loop (port of tpu_audio/ops/decoding.py:
decode_loop, DecodeResult).

The JAX package runs the loop as one compiled `while_loop`; here it runs
eagerly, with every piece of loop state (the token buffer, the last token,
the recent-token ring, the `finished` flags, the model state) on the
device. The host reads `finished.all()` once every `SYNC_EVERY` steps to
stop early. The steps run after every row finished emit `pad_id`, leave
the ring and the last token as they were and are not counted, so tokens,
lengths, the ring and the last token equal the JAX loop's; only the model
state has run those few steps further.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_audio_torch.ops.sampling import SamplerConfig, sample, update_recent

SYNC_EVERY = 8  # steps between the host's reads of `finished`


@dataclass
class DecodeResult:
    tokens: torch.Tensor         # (B, max_new) generated ids, padded with pad_id
    lengths: torch.Tensor        # (B,) valid tokens (excluding EOS)
    last_state: object           # final model state (e.g. the KV cache)
    recent: torch.Tensor | None = None     # (B, W) recent-token ring
    finished: torch.Tensor | None = None   # (B,) EOS reached
    last_token: torch.Tensor | None = None  # (B,) last emitted token


def decode_loop(step_fn: Callable, state, first_token: torch.Tensor, max_new_tokens: int,
                eos_ids, sampler: SamplerConfig = SamplerConfig(),
                generator: torch.Generator | None = None,
                logit_processor: Callable | None = None,
                token_postprocess: Callable | None = None, min_tokens: int = 0,
                pad_id: int = 0, recent0: torch.Tensor | None = None,
                finished0: torch.Tensor | None = None, early_exit: bool = True,
                noise: Callable | None = None) -> DecodeResult:
    """Sample up to max_new_tokens from step_fn(last (B, 1), state) →
    (logits (B, V), state), stopping early once every row hit an EOS id.

    generator: the sampler's draws at temperature > 0; noise(i) → (B, V)
    Gumbel noise for step i instead (tests feed the JAX package's draws).
    recent0/finished0 resume a previous span's sampling state.
    early_exit=False always runs all max_new_tokens steps."""
    b = first_token.shape[0]
    dev = first_token.device
    eos = torch.as_tensor(eos_ids, dtype=torch.int64, device=dev).reshape(1, -1)
    window = max(sampler.repetition_window, sampler.ras_window, 1)
    tokens = torch.full((b, max_new_tokens), pad_id, dtype=torch.int64, device=dev)
    last = first_token.to(torch.int64)
    if recent0 is None:
        # the ring starts with first_token, as in the JAX loop
        recent0 = update_recent(torch.full((b, window), -1, dtype=torch.int64, device=dev), last)
    recent = recent0.to(torch.int64)
    finished = (torch.zeros(b, dtype=torch.bool, device=dev) if finished0 is None
                else finished0.clone())
    vocab_eos = None
    n_live = torch.zeros((), dtype=torch.int64, device=dev)  # the steps JAX would run
    for i in range(max_new_tokens):
        if early_exit and i and i % SYNC_EVERY == 0 and bool(finished.all()):
            break
        live = ~finished.all()  # on the device: False only for steps JAX would not run
        n_live = n_live + live.long()
        logits, state = step_fn(last[:, None], state)
        if logit_processor is not None:
            logits = logit_processor(logits, i, recent)
        if i < min_tokens:
            if vocab_eos is None:
                vocab_eos = torch.isin(torch.arange(logits.shape[-1], device=dev), eos[0])
            logits = torch.where(vocab_eos[None], torch.full_like(logits, -1e30), logits)
        tok = sample(logits, sampler, recent, generator,
                     None if noise is None else noise(i)).to(torch.int64)
        if token_postprocess is not None:
            tok = token_postprocess(tok, i)
        is_eos = (tok[:, None] == eos).any(dim=-1)
        tok = torch.where(finished, pad_id, tok)
        tokens[:, i] = tok
        ring = update_recent(recent, torch.where(is_eos | finished, -1, tok))
        recent = torch.where(live, ring, recent)
        last = torch.where(live, tok, last)
        finished = finished | is_eos
    eos_hit = (tokens[:, :, None] == eos[None]).any(dim=-1)
    first_eos = (eos_hit.int().argmax(dim=-1) if max_new_tokens
                 else torch.zeros(b, dtype=torch.int64, device=dev))
    lengths = torch.where(eos_hit.any(dim=-1), first_eos, n_live)
    return DecodeResult(tokens=tokens, lengths=lengths, last_state=state, recent=recent,
                        finished=finished, last_token=last)
