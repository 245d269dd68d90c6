"""CosyVoice3 streaming synthesis: token chunks → incremental mel → audio
(port of tpu_audio/models/cosyvoice3/model.py: SILENT_TOKENS, CHUNK_SIZE,
PRE_LOOKAHEAD, CV3FlowConfig, init_params, pre_lookahead,
filter_silent_tokens, flow_chunk, make_flow_stream_caches, cfm_solve_chunk,
roll_stream_caches, CV3Synthesizer).

The flow: the token embedding → the pre-lookahead layer (a k = 4 conv over
the next 3 tokens, leaky ReLU, a causal k3 conv, the residual) → each row
repeated token_mel_ratio (2) times → a 512-wide mu, and the DiT estimator
(`dit.py`) solves the CFG Euler flow from an 80-wide z (drawn by the
caller's `noise`, so no `out_dim` is needed) → mel → the causal HiFT.

`CV3Synthesizer.stream` has two flow policies. The full window re-runs the
flow over every token so far each chunk, with chunk-causal masks (the
reference's). The O(1) flow keeps each timestep's frozen keys and values
(`dit.forward_chunk`) in a ring of `stream_cache_frames`, with a bounded
left window (2 chunks of 50 frames, beyond the reference's unbounded one),
and solves the new frames only. o1_flow="auto" runs the full window until
it passes `o1_switch_frames`, then primes the caches over the attention
horizon in one call and goes on at O(1). The flow's z comes from
`noise.z` (the full window) and `noise.z_chunk` (a chunk from its first
frame); HiFT's draws from `hift_noise`, keyed by position
(`codecs/s3gen/noise.Noise` by default), so a test can hand in the JAX
package's draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs.s3gen import flow, hift
from tpu_audio_torch.codecs.s3gen.noise import Noise
from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.convert import s3_params_from_numpy
from tpu_audio_torch.models.cosyvoice3 import dit
from tpu_audio_torch.nn import layers

SILENT_TOKENS = {1, 2, 28, 29, 55, 248, 494, 2241, 2242, 2322, 2323}
MAX_SILENT_RUN = 5
CHUNK_SIZE = 25
PRE_LOOKAHEAD = 3


@dataclass(frozen=True)
class CV3FlowConfig:
    vocab_size: int = 6561
    input_dim: int = 512
    spk_dim: int = 192
    mel_dim: int = 80
    token_mel_ratio: int = 2
    pre_lookahead_len: int = PRE_LOOKAHEAD
    dit: dit.DiTConfig = field(default_factory=dit.DiTConfig)
    cfm: flow.CFMConfig = field(default_factory=flow.CFMConfig)
    hift: hift.HiFTConfig = field(default_factory=hift.HiFTConfig)


def tp_config(cfg: CV3FlowConfig, tp: int) -> CV3FlowConfig:
    """The config a rank of `tp` serves its DiT shards at
    (`parallel.shardings.local_tree` with flow_rules): the heads divided by
    tp."""
    if cfg.dit.heads % tp:
        raise ValueError(f"DiT heads {cfg.dit.heads} not divisible by tp={tp}")
    return replace(cfg, dit=replace(cfg.dit, heads=cfg.dit.heads // tp))


def numpy_params(rng: np.random.Generator, cfg: CV3FlowConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts) as f32 numpy arrays."""
    init, d = Init(rng), cfg.dit.dim
    return {"input_embedding": init.embedding(cfg.vocab_size, cfg.input_dim),
            "spk_embed_affine_layer": init.linear(cfg.spk_dim, cfg.dit.spk_dim),
            "pre_lookahead_layer": {"conv1": init.conv(cfg.input_dim, d, cfg.pre_lookahead_len + 1),
                                    "conv2": init.conv(d, cfg.input_dim, 3)},
            "decoder_estimator": dit.numpy_params(rng, cfg.dit),
            "mel2wav": hift.numpy_params(rng, cfg.hift)}


def init_params(seed: int, cfg: CV3FlowConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed, on the card unless `device`
    says otherwise."""
    return s3_params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


def pre_lookahead(p, x: torch.Tensor, pre_len: int) -> torch.Tensor:
    """Each position reads pre_len future rows through conv1 (k = pre_len +
    1, leaky ReLU 0.01), then a causal k3 conv, plus x. x (B, T, C) zero
    past its real length."""
    h = F.leaky_relu(layers.conv1d(p["conv1"], F.pad(x, (0, 0, 0, pre_len))), 0.01)
    return layers.conv1d(p["conv2"], h, padding=(2, 0)) + x


def filter_silent_tokens(tokens: list[int], max_run: int = MAX_SILENT_RUN) -> list[int]:
    """Drop silent tokens past a run of max_run."""
    out, run = [], 0
    for t in tokens:
        if t in SILENT_TOKENS:
            run += 1
            if run > max_run:
                continue
        else:
            run = 0
        out.append(t)
    return out


def _mu(params, cfg: CV3FlowConfig, tokens: torch.Tensor, token_len, embedding):
    """(mu (1, ratio · T, input_dim): the embedded tokens, zero past
    token_len, through the pre-lookahead layer and repeated; spks (1, spk))."""
    emb = embedding / torch.clamp(embedding.norm(dim=-1, keepdim=True), min=1e-8)
    spks = layers.linear(params["spk_embed_affine_layer"], emb)
    x = layers.embedding(params["input_embedding"], torch.clamp(tokens, 0, cfg.vocab_size - 1))
    live = torch.arange(x.shape[1], device=x.device)[None, :, None] < token_len
    x = torch.where(live, x, torch.zeros_like(x))
    h = pre_lookahead(params["pre_lookahead_layer"], x, cfg.pre_lookahead_len)
    return torch.repeat_interleave(h, cfg.token_mel_ratio, dim=1), spks


def flow_chunk(params, cfg: CV3FlowConfig, tokens: torch.Tensor, token_len: int, prompt_mel,
               prompt_mel_len: int, embedding, noise, streaming: bool) -> torch.Tensor:
    """tokens (1, T) (the prompt's and the generated window) → mel (1, 2T,
    mel_dim). With streaming the last pre_lookahead_len real tokens are
    context only (valid mel (token_len − 3) · 2), as the reference's
    finalize=false pass."""
    mu, spks = _mu(params, cfg, tokens, token_len, embedding)
    h_len = token_len - (cfg.pre_lookahead_len if streaming else 0)
    t2 = mu.shape[1]
    cond = torch.zeros((1, t2, cfg.mel_dim), dtype=mu.dtype, device=mu.device)
    n = min(prompt_mel.shape[1], t2, prompt_mel_len)
    cond[:, :n] = prompt_mel[:, :n].to(mu.dtype)
    z = noise.z((1, t2, cfg.mel_dim), mu.device)
    m_len = torch.tensor([h_len * cfg.token_mel_ratio], device=mu.device)

    def est(x, ml, mu_, t, spks_, cond_, stream):
        return dit.forward(params["decoder_estimator"], cfg.dit, x, ml, mu_, t, spks_, cond_,
                           stream)
    return flow.cfm_solve(est, cfg.cfm, mu, m_len, spks, cond, z, streaming=streaming)


def make_flow_stream_caches(cfg: CV3FlowConfig, s_max: int, n_timesteps: int | None = None,
                            dtype=torch.float32,
                            device: torch.device | str = "cuda") -> dit.DiTStreamCache:
    """A DiT stream cache a flow timestep, stacked on a leading axis, at
    batch 2 (CFG's conditioned and unconditioned rows)."""
    n = n_timesteps or cfg.cfm.n_timesteps
    one = dit.make_stream_cache(cfg.dit, 2, s_max, dtype, device)
    return dit.DiTStreamCache(**{k: torch.zeros((n, *v.shape), dtype=v.dtype, device=v.device)
                                 for k, v in vars(one).items()})


def _step_cache(caches: dit.DiTStreamCache, i: int) -> dit.DiTStreamCache:
    """Timestep i's cache: views, so that writes land in the stack."""
    return dit.DiTStreamCache(**{k: v[i] for k, v in vars(caches).items()})


def cfm_solve_chunk(params, cfg: CV3FlowConfig, z_new, mu_new, spks, cond_new,
                    caches: dit.DiTStreamCache, valid_new=None,
                    n_timesteps: int | None = None) -> torch.Tensor:
    """The CFG Euler solve over the new frames only, each timestep reading
    and advancing its own frozen cache (in place): `flow.cfm_solve`
    restricted to the chunk."""
    n_steps = n_timesteps or cfg.cfm.n_timesteps
    b = mu_new.shape[0]
    if b != 1:
        raise ValueError("the streaming flow is single-stream (batch 1)")
    ts = flow.t_span(cfg.cfm, n_steps, mu_new.device)
    rate = cfg.cfm.inference_cfg_rate
    mu_in = torch.cat([mu_new, torch.zeros_like(mu_new)])
    spk_in = torch.cat([spks, torch.zeros_like(spks)])
    cond_in = torch.cat([cond_new, torch.zeros_like(cond_new)])
    x = z_new.to(mu_new.dtype)
    for i in range(n_steps):
        t_in = ts[i].to(mu_new.dtype).expand(2 * b)
        v = dit.forward_chunk(params["decoder_estimator"], cfg.dit, torch.cat([x, x]), mu_in,
                              t_in, spk_in, cond_in, _step_cache(caches, i), valid_new)
        v_cfg = (1.0 + rate) * v[:b] - rate * v[b:]
        x = (x.float() + (ts[i + 1] - ts[i]) * v_cfg.float()).to(x.dtype)
    return x


def roll_stream_caches(caches: dit.DiTStreamCache, shift: int) -> dit.DiTStreamCache:
    """Slide every timestep's keys and values left by `shift` slots (a
    multiple of static_chunk_size, so absolute chunk boundaries hold; the
    rotated K/V move unchanged), the freed tail zero; base advances and
    pos retreats by shift."""
    def roll(a):  # (n, depth, B, S, H, hd): slide S
        out = torch.zeros_like(a)
        out[:, :, :, :a.shape[3] - shift] = a[:, :, :, shift:]
        return out
    return dit.DiTStreamCache(k=roll(caches.k), v=roll(caches.v), conv1_tail=caches.conv1_tail,
                              conv2_tail=caches.conv2_tail, pos=caches.pos - shift,
                              base=caches.base + shift)


class CV3Synthesizer:
    """The chunked streaming pipeline (host orchestration)."""

    def __init__(self, params, cfg: CV3FlowConfig, o1_flow="auto",
                 stream_cache_frames: int = 512, o1_switch_frames: int = 600):
        """o1_flow: "auto" (the full window until it passes
        o1_switch_frames mel frames, then the O(1) flow), True (the O(1)
        flow from the first chunk of a stream) or False (the full window
        throughout)."""
        self.params = params
        self.cfg = cfg
        self.o1_flow = o1_flow
        self.stream_cache_frames = stream_cache_frames
        self.o1_switch_frames = o1_switch_frames
        # the O(1) flow's ring needs a bounded left window: 2 left chunks
        self.o1_cfg = (replace(cfg, dit=replace(cfg.dit, num_left_chunks=2))
                       if cfg.dit.num_left_chunks < 0 else cfg)

    def _mu_window(self, toks, n: int, emb, lo: int, chunk_pad: int, n_valid: int):
        """(mu's frames [lo, lo + chunk_pad), zero from n_valid on; spks)."""
        mu, spks = _mu(self.params, self.cfg, toks, n, emb)
        mu = F.pad(mu, (0, 0, 0, chunk_pad))[:, lo:lo + chunk_pad]
        live = torch.arange(chunk_pad, device=mu.device)[None, :, None] < n_valid
        return torch.where(live, mu, torch.zeros_like(mu)), spks

    @torch.inference_mode()
    def stream(self, token_chunks: Iterator[list[int]], prompt_tokens: list[int],
               prompt_mel: torch.Tensor, embedding: torch.Tensor, *, seed: int = 0,
               chunk_size: int = CHUNK_SIZE, flow_noise=None,
               hift_noise=None) -> Iterator[np.ndarray]:
        """Consume the LM's token chunks (silent runs filtered), yield new
        audio (f32 numpy). prompt_mel (P, 80) or (1, P, 80); embedding
        (1, spk). The flow's z and HiFT's draws come from `flow_noise` /
        `hift_noise` (by default `Noise(seed)`)."""
        cfg = self.cfg
        flow_noise = flow_noise or Noise(seed)
        hift_noise = hift_noise or Noise(seed)
        dev = embedding.device
        p_len = len(prompt_tokens)
        pm = (prompt_mel if prompt_mel.dim() == 3 else prompt_mel[None]).to(dev)
        pm0 = pm[0].float()
        ratio, ups = cfg.token_mel_ratio, cfg.hift.upsample_scale
        dtype = self.params["mel2wav"]["conv_pre"]["weight"].dtype
        lb_max, static = hift.LOOKBACK_FRAMES, cfg.dit.static_chunk_size
        horizon = (self.o1_cfg.dit.num_left_chunks + 1) * static

        gen_tokens: list[int] = []
        emitted, done, chunks = 0, False, iter(token_chunks)
        phase = torch.zeros((1, cfg.hift.nb_harmonics + 1), dtype=torch.float64, device=dev)
        source_tail = torch.zeros((1, 0), device=dev)
        voc_frames = 0  # absolute mel frames already vocoded
        caches, cache_base, o1_active = None, 0, False
        mel_tail = torch.zeros((0, cfg.mel_dim), device=dev)
        while True:
            while not done and len(gen_tokens) < emitted + chunk_size + PRE_LOOKAHEAD:
                try:
                    gen_tokens.extend(filter_silent_tokens(next(chunks)))
                except StopIteration:
                    done = True
            emit_upto = len(gen_tokens) if done else emitted + chunk_size
            if emit_upto <= emitted:
                break
            window_end = (len(gen_tokens) if done
                          else min(len(gen_tokens), emit_upto + PRE_LOOKAHEAD))
            window_toks = list(prompt_tokens) + gen_tokens[:window_end]
            n = len(window_toks)
            t_pad = max(32, -(-n // 32) * 32)
            toks = torch.zeros((1, t_pad), dtype=torch.int64)
            toks[0, :n] = torch.as_tensor(window_toks)
            toks = toks.to(dev)
            valid_frames = (p_len + emit_upto) * ratio
            lb = min(lb_max, voc_frames)
            n_new = valid_frames - voc_frames
            if not o1_active and not (done and emitted == 0) and (
                    self.o1_flow is True
                    or (self.o1_flow == "auto" and valid_frames > self.o1_switch_frames)):
                o1_active = True

            if o1_active:
                def run_chunk(lo, hi, caches, cache_base):
                    """The flow's frames [lo, hi) through the cached DiT."""
                    frames = hi - lo
                    chunk_pad = max(32, -(-frames // 32) * 32)
                    mu_new, spks = self._mu_window(toks, n, embedding, lo, chunk_pad, frames)
                    cond_new = torch.zeros((1, chunk_pad, cfg.mel_dim), dtype=mu_new.dtype,
                                           device=dev)
                    p_over = max(0, min(pm0.shape[0], hi) - lo)
                    if p_over > 0:
                        cond_new[0, :p_over] = pm0[lo:lo + p_over].to(mu_new.dtype)
                    z_new = flow_noise.z_chunk(lo, (1, chunk_pad, cfg.mel_dim), dev)
                    if caches is None:
                        s_max = max(self.stream_cache_frames,
                                    -(-(chunk_pad + static) // static) * static)
                        caches = make_flow_stream_caches(self.o1_cfg, s_max, device=dev)
                        cache_base = lo
                    slot, s_max = lo - cache_base, caches.k.shape[3]
                    if slot + chunk_pad > s_max:
                        shift = -(-(slot + chunk_pad - s_max) // static) * static
                        caches = roll_stream_caches(caches, shift)
                        cache_base += shift
                    x_new = cfm_solve_chunk(self.params, self.o1_cfg, z_new, mu_new, spks,
                                            cond_new, caches, valid_new=frames)
                    return x_new[0, :frames].float(), caches, cache_base

                if caches is None and voc_frames > 0:
                    # the switch: prime the caches over the attention horizon
                    h_start = max(0, (voc_frames - horizon) // static * static)
                    _, caches, cache_base = run_chunk(h_start, voc_frames, None, 0)
                new_mel, caches, cache_base = run_chunk(voc_frames, valid_frames, caches,
                                                        cache_base)
                window = torch.cat([mel_tail[mel_tail.shape[0] - lb:], new_mel])
                mel_tail = window[max(0, window.shape[0] - lb_max):]
            else:
                mel = flow_chunk(self.params, cfg, toks, n, pm, pm.shape[1], embedding,
                                 flow_noise, not done)[0].float()
                window = mel[voc_frames - lb:valid_frames]
                mel_tail = mel[max(0, valid_frames - lb_max):valid_frames]
            audio_w, phase, source_w = hift.vocode_window(
                self.params["mel2wav"], cfg.hift, window[None].to(dtype), hift_noise, phase,
                source_tail[:, source_tail.shape[1] - lb * ups:], voc_frames)
            new_lb = min(lb_max, valid_frames)
            source_tail = source_w[:, (lb + n_new - new_lb) * ups:]
            skip = max(0, p_len * ratio - voc_frames)  # the prompt region's samples
            new_audio = audio_w[0, (lb + skip) * ups:]
            voc_frames, emitted = valid_frames, emit_upto
            if new_audio.numel():
                yield new_audio.float().cpu().numpy()
            if done:
                break
