"""Speculative decoding: draft cheap tokens, verify them in one target pass
(port of tpu_audio/ops/speculative.py: SpecResult, propose_ngram,
speculative_decode_loop).

Each iteration drafts `gamma` tokens, runs the target once over [last,
x_0 … x_{gamma-1}] (gamma + 1 rows), accepts draft x_i with probability
min(1, p_i(x_i) / q_i(x_i)), and on the first rejection draws from
normalize(max(p_i − q_i, 0)), or after gamma acceptances a bonus token from
p_gamma: every emitted token has exactly the target sampler's distribution
(`sampling.warped_probs`, repetition penalty and RAS included). Drafts come
from a smaller model of the same vocabulary, run with its own cache, or
from the history by prompt lookup (`propose_ngram`).

The JAX package runs the loop as one `while_loop`. Here it runs eagerly
with every carried value on the device: the token buffer, `last` /
`second_last`, the recent-token ring, the n-gram history and its length,
the counters, and the caches' 0-d `pos`, which a rewind overwrites in
place (`pos.copy_`). The host reads whether the loop is done once every
`SYNC_EVERY` iterations; the iterations JAX would not have run leave every
carried value as it was (`torch.where(live, new, old)`), and the buffers
and caches have room for their writes (`loop_slots`).

The accept step is one plain function of (p, q, x, u, g), batched over a
leading axis (`accept`). The draws of an iteration, in the JAX loop's
order: the draft model's samples (each (2, 1, V) under RAS, else (1, V);
none when greedy), the uniforms u (gamma,), the categorical's Gumbel noise
g (1, V). They come from a `torch.Generator`, or from `draws(iteration)`,
which a test fills with `jax.random` output of the same key splits.
Batch size 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_audio_torch.ops import sampling
from tpu_audio_torch.ops.decoding import SYNC_EVERY
from tpu_audio_torch.ops.sampling import SamplerConfig, update_recent


@dataclass
class SpecResult:
    tokens: torch.Tensor      # (1, max_new + gamma + 1) ids, padded with pad_id
    lengths: torch.Tensor     # (1,) valid tokens (EOS excluded, ≤ max_new)
    last_state: object        # the target cache (its pos rewound)
    iterations: torch.Tensor  # 0-d: iterations run
    drafted: torch.Tensor     # 0-d: tokens drafted
    accepted: torch.Tensor    # 0-d: drafted tokens accepted
    emitted: torch.Tensor     # 0-d: tokens written, the overshoot past max_new included
    finished: torch.Tensor    # 0-d bool: EOS emitted
    last: torch.Tensor        # (1,) the last emitted token
    second_last: torch.Tensor  # (1,) the token before it
    recent: torch.Tensor      # (1, W) the recent-token ring
    history: torch.Tensor     # (1, H) the n-gram history with the emitted tokens
    history_len: torch.Tensor  # 0-d


def loop_slots(max_new_tokens: int, gamma: int) -> int:
    """Cache slots the loop writes past the target's `pos` at entry: the
    last live verify ends ≤ max_new + gamma on, and a no-op iteration after
    it writes gamma + 1 more."""
    return max_new_tokens + 2 * (gamma + 1)


def target_pos(p_t: torch.Tensor, n_acc: torch.Tensor) -> torch.Tensor:
    """The target's pos after an iteration that verified from p_t: its cache
    keeps [last, x_0 … x_{n_acc-1}]; the extra token is the next `last`."""
    return p_t + n_acc + 1


def draft_pos(p_t: torch.Tensor, n_acc: torch.Tensor) -> torch.Tensor:
    """The draft's pos after the iteration: one slot behind the target's,
    so that its next 2-token step re-writes second_last's slot."""
    return p_t + n_acc


def residual(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The rejection's distribution, unnormalised: max(p − q, 0)."""
    return torch.clamp(p - q, min=0.0)


def propose_ngram(hist: torch.Tensor, hist_len: torch.Tensor, second_last: torch.Tensor,
                  last: torch.Tensor, gamma: int) -> torch.Tensor:
    """Prompt lookup: the gamma tokens after the most recent occurrence of
    (second_last, last) in hist (1, H) (valid at [0, hist_len)), else after
    the most recent `last`, else after the history's end. The start is
    clamped to [0, H − gamma], as `dynamic_slice` clamps it. (1, gamma)."""
    h = hist[0]
    n = h.shape[0]
    idx = torch.arange(n, device=h.device)
    prev = torch.cat([h.new_full((1,), -1), h[:-1]])
    m1 = (h == last[0]) & (idx < hist_len - 1)
    m2 = m1 & (prev == second_last[0]) & (idx >= 1)
    none = torch.full_like(idx, -1)
    j2, j1 = torch.where(m2, idx, none).amax(), torch.where(m1, idx, none).amax()
    j = torch.where(j2 >= 0, j2, torch.where(j1 >= 0, j1, hist_len - 1))
    start = torch.clamp(j + 1, min=0, max=n - gamma)
    return h[start + torch.arange(gamma, device=h.device)][None]


def accept(p: torch.Tensor, q: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
           g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The accept step, batched over N: p, q (N, gamma + 1, V) the target's
    and the draft's probabilities (q[:, gamma] = 0), x (N, gamma) the drafts,
    u (N, gamma) uniforms, g (N, V) Gumbel noise → (n_acc (N,), the leading
    run of u·q(x) < p(x); extra (N,), the Gumbel argmax of log max(p − q, 0)
    at row n_acc: the residual on a rejection, p_gamma after gamma
    acceptances)."""
    gamma = x.shape[1]
    p_at = p[:, :gamma].gather(2, x[..., None])[..., 0]
    q_at = q[:, :gamma].gather(2, x[..., None])[..., 0]
    n_acc = (u * q_at < p_at).long().cumprod(dim=1).sum(dim=1)
    rows = torch.arange(p.shape[0], device=p.device)
    res = residual(p[rows, n_acc], q[rows, n_acc])
    logits = torch.where(res > 0, torch.log(torch.clamp(res, min=1e-38)),
                         torch.full_like(res, -torch.inf))
    return n_acc, (logits + g).argmax(dim=-1)


def _one_hot(ids: torch.Tensor, v: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(ids, v).float()


def speculative_decode_loop(
        target_step: Callable, target_cache, first_token: torch.Tensor,
        second_last: torch.Tensor, max_new_tokens: int, gamma: int, eos_ids,
        sampler: SamplerConfig = SamplerConfig(), pad_id: int = 0,
        draft_step: Callable | None = None, draft_cache=None,
        history: torch.Tensor | None = None, history_len: torch.Tensor | None = None,
        logit_processor: Callable | None = None, recent0: torch.Tensor | None = None,
        append_first_to_history: bool = True, generator: torch.Generator | None = None,
        draws: Callable | None = None, iteration0: int = 0) -> SpecResult:
    """Up to max_new_tokens after first_token (not itself written, as in
    `decoding.decode_loop`). target_step / draft_step: (tokens (1, T),
    cache) → (logits (1, T, V) f32, cache), advancing the cache in place;
    draft_step None drafts from `history` by prompt lookup.
    logit_processor(logits (1, V), abs_idx (0-d tensor), recent): the
    0-based index in the generated stream of the token being drawn.

    At each iteration's start target.pos = P (the cache holds everything
    before `last`) and draft.pos = P − 1: the first 2-token draft step
    re-writes second_last's slot, then `last`'s. Both caches need
    `loop_slots(max_new_tokens, gamma)` slots past P. draws(iteration0 + i)
    → {"draft": [noise a draft token], "u": (gamma,), "g": (1, V)} for
    iteration i, instead of `generator`'s."""
    dev = first_token.device
    if first_token.shape[0] != 1:
        raise ValueError("speculative decoding is single-stream (batch 1)")
    ngram, greedy = draft_step is None, sampler.temperature == 0.0
    ras = sampler.ras
    eos = torch.as_tensor(eos_ids, dtype=torch.int64, device=dev).reshape(-1)
    window = max(sampler.repetition_window, sampler.ras_window, 1)
    buf = torch.full((1, max_new_tokens + 2 * (gamma + 1)), pad_id, dtype=torch.int64,
                     device=dev)
    if history is None:
        history = torch.zeros((1, 8), dtype=torch.int64, device=dev)
        history_len = torch.zeros((), dtype=torch.int64, device=dev)
    hist = history.to(torch.int64).clone()
    hist_len = torch.as_tensor(history_len, dtype=torch.int64, device=dev).reshape(()).clone()
    last = first_token.to(torch.int64)
    second_last = second_last.to(torch.int64)
    if recent0 is None:
        recent0 = update_recent(torch.full((1, window), -1, dtype=torch.int64, device=dev), last)
    recent = recent0.to(torch.int64)
    if append_first_to_history:
        hist[0].index_copy_(0, torch.clamp(hist_len, max=hist.shape[1] - 1)[None], last)
        hist_len = hist_len + 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    i_out, iters, n_drafted, n_accepted = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    finished = torch.isin(last, eos).any()
    bidx = torch.arange(gamma + 1, device=dev)
    h_w = hist.shape[1]

    def warped(logits, recents, abs_idx):
        """The target's distributions (rows, V) of logits (rows, V), row i
        drawn after recents[i] at abs_idx + i."""
        if logit_processor is not None:
            logits = torch.cat([logit_processor(logits[i:i + 1], abs_idx + i, recents[i:i + 1])
                                for i in range(logits.shape[0])])
        if greedy:
            if sampler.repetition_penalty != 1.0:
                logits = sampling.apply_repetition_penalty(logits, recents,
                                                           sampler.repetition_penalty)
            return _one_hot(logits.argmax(dim=-1), logits.shape[-1])
        return sampling.warped_probs(logits, sampler, recents)

    def draw(shape):
        return sampling.gumbel(shape, generator, dev)

    for it in range(max_new_tokens):
        if it % SYNC_EVERY == 0 and not bool((i_out < max_new_tokens) & ~finished):
            break
        live = (i_out < max_new_tokens) & ~finished
        given = draws(iteration0 + it) if draws is not None else None
        if given is None and generator is None and not greedy:
            raise ValueError("sampling at temperature > 0 needs a generator or draws")
        p_t = target_cache.pos.clone()

        # ---- propose gamma tokens and the recent-token rings they imply
        recents, q_rows = [recent], []
        if ngram:
            x = propose_ngram(hist, hist_len, second_last, last, gamma)
            for g in range(gamma):
                recents.append(update_recent(recents[-1], x[:, g]))
        else:
            d_pos = draft_cache.pos.clone()
            toks, d_in = [], torch.stack([second_last, last], dim=1)
            for g in range(gamma):
                lg, draft_cache = draft_step(d_in, draft_cache)
                lg = lg[:, -1].float()
                if logit_processor is not None:
                    lg = logit_processor(lg, i_out + g, recents[-1])
                noise = None
                if not greedy:
                    noise = (given["draft"][g] if given is not None
                             else draw(((2,) if ras else ()) + tuple(lg.shape)))
                tok = sampling.sample(lg, sampler, recents[-1], noise=noise)
                toks.append(tok)
                if not greedy:
                    q_rows.append(sampling.warped_probs(lg, sampler, recents[-1]))
                recents.append(update_recent(recents[-1], tok))
                d_in = tok[:, None]
            x = torch.stack(toks, dim=1)

        # ---- one target forward over [last, x_0 … x_{gamma-1}]
        t_logits, target_cache = target_step(torch.cat([last[:, None], x], dim=1), target_cache)
        v = t_logits.shape[-1]
        recents_stack = torch.cat(recents)  # (gamma + 1, W)
        p_stack = warped(t_logits[0].float(), recents_stack, i_out)
        q_stack = _one_hot(x[0], v) if ngram or greedy else torch.cat(q_rows)
        q_stack = torch.cat([q_stack, q_stack.new_zeros((1, v))])
        u = given["u"] if given is not None else torch.rand((gamma,), generator=generator,
                                                             device=dev)
        g_noise = given["g"] if given is not None else draw((1, v))
        n_acc, extra = accept(p_stack[None], q_stack[None], x, u.reshape(1, gamma).float(),
                              g_noise.reshape(1, v).float())
        n_acc, extra = n_acc[0], extra[0]

        # ---- the emitted block: x_0 … x_{n_acc-1}, extra, pad …
        x_row = torch.cat([x[0], x.new_zeros(1)])
        block = torch.where(bidx < n_acc, x_row,
                            torch.where(bidx == n_acc, extra, torch.full_like(x_row, pad_id)))
        emitted_eos = (torch.isin(block, eos) & (bidx <= n_acc)).any()
        at = i_out + bidx
        buf[0].index_copy_(0, at, torch.where(live, block, buf[0, at]))

        # ---- the state rolled forward to the accepted prefix
        x_ext = torch.cat([last, x[0]])
        n_emit = n_acc + 1
        target_cache.pos.copy_(torch.where(live, target_pos(p_t, n_acc), p_t))
        if not ngram:
            draft_cache.pos.copy_(torch.where(live, draft_pos(p_t, n_acc), d_pos))
        else:
            h_at = torch.clamp(hist_len, max=h_w - (gamma + 1)) + bidx
            hist[0].index_copy_(0, h_at, torch.where(live, block, hist[0, h_at]))
            hist_len = torch.where(live, hist_len + n_emit, hist_len)
        new_recent = update_recent(recents_stack[n_acc][None], extra[None])
        recent = torch.where(live, new_recent, recent)
        second_last = torch.where(live, x_ext[n_acc][None], second_last)
        last = torch.where(live, extra[None], last)
        finished = finished | (live & emitted_eos)
        i_out = torch.where(live, i_out + n_emit, i_out)
        iters = iters + live.long()
        n_drafted = n_drafted + live.long() * gamma
        n_accepted = n_accepted + torch.where(live, n_acc, zero)

    tokens = buf[:, :max_new_tokens + gamma + 1]
    eos_hit = torch.isin(tokens, eos)
    first_eos = eos_hit.long().argmax(dim=-1)
    lengths = torch.where(eos_hit.any(dim=-1), first_eos, i_out)
    lengths = torch.clamp(lengths, max=max_new_tokens)
    return SpecResult(tokens=tokens, lengths=lengths, last_state=target_cache, iterations=iters,
                      drafted=n_drafted, accepted=n_accepted, emitted=i_out, finished=finished,
                      last=last, second_last=second_last, recent=recent, history=hist,
                      history_len=hist_len)
