"""Token sampling on the device (port of tpu_audio/ops/sampling.py:
SamplerConfig, sample, warp_logits, apply_top_k, apply_top_p, apply_min_p,
apply_repetition_penalty, update_recent, repetition-aware sampling,
mask_tokens, and `warped_probs`, the exact distribution `sample` draws
from, for speculative decoding).

Every operation stays on the logits' device, so a decode loop never reads
them back. Top-k and top-p are exact (a sort or `torch.topk`); the JAX
module's approximate top-k and its top-p head over large vocabularies are
TPU devices. A categorical draw is the Gumbel argmax: argmax(logits + g)
with g = -log(-log(u)), u uniform in (0, 1), drawn from the caller's
`torch.Generator`, or g handed in as `noise`, so that a test can feed the
JAX package's own draws (`jax.random.gumbel` of the same key).

Repetition-aware sampling (CosyVoice's RAS, `cfg.ras`): when the drawn
token occurs more than `ras_max_repeats` times in the last `ras_window`
tokens of `recent`, it is redrawn from the warped logits with that token
excluded. A RAS step takes two Gumbel draws, both made every step as the
JAX sampler makes both: noise (2, B, V), the second for the redraw (JAX:
`gumbel(key)` and `gumbel(fold_in(key, 1))`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_k: int = 0  # 0 = off
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    repetition_window: int = 64
    ras: bool = False
    ras_window: int = 10
    ras_max_repeats: int = 2


def _cutoff(logits: torch.Tensor, kth: torch.Tensor) -> torch.Tensor:
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    return _cutoff(logits, torch.topk(logits, k, dim=-1).values[..., -1:])


def _top_p_kth(sorted_desc: torch.Tensor, p: float) -> torch.Tensor:
    """The smallest kept value of descending logits: tokens whose
    cumulative probability before them is < p (always at least one)."""
    probs = torch.softmax(sorted_desc, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    inf = torch.full_like(sorted_desc, float("inf"))
    return torch.where(keep, sorted_desc, inf).amin(dim=-1, keepdim=True)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    return _cutoff(logits, _top_p_kth(torch.sort(logits, dim=-1, descending=True).values, p))


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    cutoff = min_p * probs.amax(dim=-1, keepdim=True)
    return torch.where(probs < cutoff, torch.full_like(logits, NEG_INF), logits)


def apply_repetition_penalty(logits: torch.Tensor, recent: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """recent: (B, W) token ids with -1 padding. Divides positive and
    multiplies negative logits of recently seen tokens by `penalty`."""
    if penalty == 1.0:
        return logits
    b, v = logits.shape
    seen = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, recent.long() + 1, True)  # column 0 takes the -1 pads
    seen = seen[:, 1:]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def mask_tokens(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Additive suppression mask (V,) or (B, V): 0 allowed, NEG_INF banned."""
    return logits + mask


def warp_logits(logits: torch.Tensor, cfg: SamplerConfig,
                recent: torch.Tensor | None = None) -> torch.Tensor:
    """Repetition penalty → temperature → top-k/top-p → min-p; the
    distribution `sample` draws from. Not for temperature 0."""
    if cfg.repetition_penalty != 1.0 and recent is not None:
        logits = apply_repetition_penalty(logits, recent, cfg.repetition_penalty)
    logits = logits / cfg.temperature
    v = logits.shape[-1]
    if 0 < cfg.top_k < v and cfg.top_p < 1.0:
        # top-k then top-p: the nucleus is found within the top-k values
        vals = torch.topk(logits, cfg.top_k, dim=-1).values
        logits = _cutoff(logits, _top_p_kth(vals, cfg.top_p))
    else:
        logits = apply_top_p(apply_top_k(logits, cfg.top_k), cfg.top_p)
    return apply_min_p(logits, cfg.min_p)


def warped_probs(logits: torch.Tensor, cfg: SamplerConfig,
                 recent: torch.Tensor | None = None) -> torch.Tensor:
    """The probabilities (B, V) `sample` draws from at temperature > 0,
    RAS's two-stage redraw marginalised in closed form: with P the warped
    softmax and S = Σ_{t bad} P(t) / (1 − P(t)) over the tokens repeated
    too often, P'(x) = P(x) · ([x ok] + S − [x bad] · P(x) / (1 − P(x)))."""
    p = torch.softmax(warp_logits(logits, cfg, recent), dim=-1)
    if not (cfg.ras and recent is not None):
        return p
    window = recent[:, -cfg.ras_window:]
    vocab = torch.arange(p.shape[-1], device=p.device, dtype=window.dtype)
    reps = (vocab[None, :, None] == window[:, None, :]).sum(dim=-1)  # (B, V)
    bad = reps > cfg.ras_max_repeats
    ratio = p / torch.clamp(1.0 - p, min=1e-30)
    zero = torch.zeros_like(p)
    s = torch.where(bad, ratio, zero).sum(dim=-1, keepdim=True)
    return p * (torch.where(bad, zero, torch.ones_like(p)) + s - torch.where(bad, ratio, zero))


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise of `shape` from `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny, max=1.0 - 2 ** -24)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, cfg: SamplerConfig, recent: torch.Tensor | None = None,
           generator: torch.Generator | None = None,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """logits (B, V) → token ids (B,) int64. Greedy when temperature == 0;
    otherwise argmax of the warped logits plus Gumbel noise (`noise`, or
    drawn from `generator`). With RAS (and `recent`), noise is (2, B, V):
    the draw, then the redraw of a token repeated too often."""
    if cfg.temperature == 0.0:
        if cfg.repetition_penalty != 1.0 and recent is not None:
            logits = apply_repetition_penalty(logits, recent, cfg.repetition_penalty)
        return logits.argmax(dim=-1)
    logits = warp_logits(logits, cfg, recent)
    ras = cfg.ras and recent is not None
    if noise is None:
        if generator is None:
            raise ValueError("sampling at temperature > 0 needs a generator or noise")
        noise = gumbel(((2,) if ras else ()) + tuple(logits.shape), generator, logits.device)
    if not ras:
        return (logits + noise).argmax(dim=-1)
    tok = (logits + noise[0]).argmax(dim=-1)
    return ras_resample(logits, tok, recent, cfg, noise[1])


def ras_resample(logits: torch.Tensor, tok: torch.Tensor, recent: torch.Tensor,
                 cfg: SamplerConfig, noise: torch.Tensor) -> torch.Tensor:
    """The RAS redraw: where tok occurs more than ras_max_repeats times in
    the last ras_window entries of recent (B, W), argmax(logits + noise)
    over the warped logits with tok excluded; tok elsewhere."""
    window = recent[:, -cfg.ras_window:]
    need = (window == tok[:, None].to(window.dtype)).sum(dim=-1) > cfg.ras_max_repeats
    excl = logits.scatter(1, tok[:, None], NEG_INF)
    alt = (excl + noise).argmax(dim=-1)
    return torch.where(need, alt, tok)


def update_recent(recent: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Shift the (B, W) recent-token ring left and append token (B,)."""
    return torch.cat([recent[:, 1:], token[:, None].to(recent.dtype)], dim=1)
