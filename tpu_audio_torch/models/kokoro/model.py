"""Kokoro's acoustic model and iSTFT-NSF generator at fixed shapes (port of
tpu_audio/models/kokoro/model.py: init_params, adain, ada_layer_norm,
adain_res_blk1d, gen_res_block, bert_duration_features, duration_encode,
predict_durations, alignment_matrix, f0n_predict, text_encode,
sine_source, generator, decode).

The token axis is padded to 512 and the frame axis to a bucket: the
instance norms take their statistics from the valid frames only and the
BiLSTMs run their backward direction from the last valid frame
(`nn/lstm.masked_bilstm`), so padded execution computes what the exact
shapes would. Tensors are channels-last (B, T, C), one sentence a batch.

Layouts: the JAX tree stores every convolution (K, I, O). Kokoro's own
rule (`params_from_numpy`) takes convolutions, weight-normalised ones
included, to torch's (O, I, K) and the transposed ones (the generator's
`ups` and every `pool`) to (I, O, K) by (1, 2, 0), their `weight_v` and
`weight_g` alike; the generic `convert.params_from_numpy` would give the
transposed ones (O, I, K), which for the square `pool` passes every shape
check with each tap transposed. A transposed convolution's weight norm is
taken per input channel (over O and K, torch's `weight_norm(dim=0)` on a
ConvTranspose1d) and `weight_g` multiplies in the orientation it is stored
in, as the JAX module multiplies it: (1, O, 1) from `init_params`, (I, 1,
1) from a per-input (1, I, 1) (ROADMAP C25). A depthwise `pool` ((K, 1, C)
in the JAX tree, (1, C, K) here) runs with groups = C (`layers.
conv_transpose1d` infers it).

The sine source draws from an explicit `torch.Generator` (`rng`, on the
inputs' device), or takes injected `rand_ini` / `noise` (the tests inject
JAX's draws). `decode` and `generator` take the source spectrum as an
input (`har`), the JAX `generator(har_override=)`: it is computed apart
(`source_spectrum`) or injected (the STFT phase of near-silent bins sits
on the ±π branch cut, where two float implementations differ by 2π).
Every function computes in its inputs' dtype (f32, or f64 for a reference).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch import convert
from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.models.kokoro import albert
from tpu_audio_torch.models.kokoro.config import KokoroConfig
from tpu_audio_torch.nn import layers, lstm
from tpu_audio_torch.ops import stft as stft_ops
from tpu_audio_torch.ops import windows
from tpu_audio_torch.ops.interpolate import linear_resize, nearest_2x
from tpu_audio_torch.utils import pytree

LRELU_SLOPE = 0.2
CONV_T_KEYS = ("ups", "pool")  # transposed convolutions


# =================================================================== params

def numpy_params(rng: np.random.Generator, cfg: KokoroConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts: convolutions (K, I, O),
    every `weight_g` (1, 1, O), Snake alphas (1, 1, C)) as f32 numpy arrays
    with its initialisation ranges."""
    init = Init(rng)
    d, sd = cfg.d_model, cfg.style_dim

    def wn_conv(i, o, k, bias=True):
        base = init.conv(i, o, k, bias)
        v = base["weight"]
        p = {"weight_v": v, "weight_g": np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))}
        if bias:
            p["bias"] = base["bias"]
        return p

    def bilstm(in_size, hidden):
        def one():
            s = 1.0 / np.sqrt(hidden)
            return {"wx": init.uniform((4 * hidden, in_size), s),
                    "wh": init.uniform((4 * hidden, hidden), s),
                    "bias_ih": np.zeros(4 * hidden, np.float32),
                    "bias_hh": np.zeros(4 * hidden, np.float32)}
        return {"fwd": one(), "bwd": one()}

    def adain(ch):
        return {"fc": init.linear(sd, ch * 2)}

    def res_blk(dim_in, dim_out, upsample=False):
        p = {"conv1": wn_conv(dim_in, dim_out, 3), "conv2": wn_conv(dim_out, dim_out, 3),
             "norm1": adain(dim_in), "norm2": adain(dim_out)}
        if upsample:
            p["pool"] = wn_conv(dim_in, dim_in, 3)
        if dim_in != dim_out:
            p["conv1x1"] = wn_conv(dim_in, dim_out, 1, bias=False)
        return p

    def gen_res(ch, kernel):
        return {"convs1": {str(i): wn_conv(ch, ch, kernel) for i in range(3)},
                "convs2": {str(i): wn_conv(ch, ch, kernel) for i in range(3)},
                "adain1": {str(i): adain(ch) for i in range(3)},
                "adain2": {str(i): adain(ch) for i in range(3)},
                "alpha1": {str(i): np.ones((1, 1, ch), np.float32) for i in range(3)},
                "alpha2": {str(i): np.ones((1, 1, ch), np.float32) for i in range(3)}}

    uic, n_fft, rates = cfg.upsample_initial_channel, cfg.istft_n_fft, cfg.upsample_rates
    gen = {"m_source": {"l_linear": init.linear(cfg.harmonic_num + 1, 1)},
           "ups": {}, "noise_convs": {}, "noise_res": {}, "resblocks": {},
           "conv_post": wn_conv(uic // (2 ** len(rates)), (n_fft // 2 + 1) * 2, 7)}
    for i, k in enumerate(cfg.upsample_kernels):
        gen["ups"][str(i)] = wn_conv(uic // (2 ** i), uic // (2 ** (i + 1)), k)
    for i in range(len(rates)):
        ch = uic // (2 ** (i + 1))
        for j, k in enumerate(cfg.resblock_kernels):
            gen["resblocks"][str(i * len(cfg.resblock_kernels) + j)] = gen_res(ch, k)
        last = i + 1 == len(rates)
        stride_f0 = int(np.prod(rates[i + 1:]))
        gen["noise_convs"][str(i)] = init.conv(n_fft + 2, ch, 1 if last else stride_f0 * 2)
        gen["noise_res"][str(i)] = gen_res(ch, 11 if last else 7)

    predictor = {
        "text_encoder": {},
        "lstm": bilstm(d + sd, d // 2),
        "duration_proj": init.linear(d, cfg.max_dur),
        "shared": bilstm(d + sd, d // 2),
        "F0": {"0": res_blk(d, d), "1": res_blk(d, d // 2, True), "2": res_blk(d // 2, d // 2)},
        "N": {"0": res_blk(d, d), "1": res_blk(d, d // 2, True), "2": res_blk(d // 2, d // 2)},
        "F0_proj": init.conv(d // 2, 1, 1),
        "N_proj": init.conv(d // 2, 1, 1),
    }
    for i in range(3):
        predictor["text_encoder"][f"lstm{i}"] = bilstm(d + sd, d // 2)
        predictor["text_encoder"][f"norm{i}"] = adain(d)
    hidden = cfg.decoder_hidden
    decoder = {
        "encode": res_blk(d + 2, hidden),
        "decode": {"0": res_blk(hidden + 2 + 64, hidden), "1": res_blk(hidden + 2 + 64, hidden),
                   "2": res_blk(hidden + 2 + 64, hidden),
                   "3": res_blk(hidden + 2 + 64, d, True)},
        "F0_conv": wn_conv(1, 1, 3),
        "N_conv": wn_conv(1, 1, 3),
        "asr_res": {"0": wn_conv(d, 64, 1)},
        "generator": gen,
    }
    return {
        "bert": albert.numpy_params(rng, cfg.albert),
        "bert_encoder": init.linear(cfg.albert.hidden_size, d),
        "text_encoder": {
            "embedding": init.embedding(cfg.n_symbols, d),
            "cnn": {str(i): {"conv": wn_conv(d, d, cfg.text_encoder_kernel), "norm": init.norm(d)}
                    for i in range(cfg.text_encoder_depth)},
            "lstm": bilstm(d, d // 2),
        },
        "predictor": predictor,
        "decoder": decoder,
    }


def kokoro_perm(key: str, rank: int) -> tuple | None:
    """The permutation that takes the leaf at dotted `key` of Kokoro's JAX
    tree, of rank `rank`, to the port's layout: a transposed convolution's
    `weight_v` / `weight_g` (under "ups" or "pool") (K, I, O) → (I, O, K);
    any other `weight_v` / `weight_g`, and every 3-D `weight` (the text and
    noise convolutions, `F0_proj`, `N_proj`), (K, I, O) → (O, I, K). The
    Snake alphas (1, 1, C) and every 1-D or 2-D leaf stay as they are."""
    if rank != 3:
        return None
    parts = key.split(".")
    if parts[-1] in ("weight_v", "weight_g"):
        return (1, 2, 0) if any(p in CONV_T_KEYS for p in parts[:-1]) else (2, 1, 0)
    return (2, 1, 0) if parts[-1] == "weight" else None


def params_from_numpy(tree: dict, device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.float32) -> dict:
    """Kokoro's JAX-layout tree (numpy arrays, anything `np.asarray` takes,
    or tensors) → the port's tree on `device` (the card unless the caller
    asks for the CPU), by `kokoro_perm`, floating leaves in `dtype`."""
    return pytree.unflatten({k: convert._leaf(v, kokoro_perm(k, np.ndim(v)), device, dtype)
                             for k, v in pytree.flatten(tree).items()})


def init_params(seed: int, cfg: KokoroConfig, dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> dict:
    """Random parameters from a numpy seed with the JAX tree's keys, shapes
    and initialisation ranges, in the port's layouts, on the card unless
    `device` says otherwise."""
    return params_from_numpy(numpy_params(np.random.default_rng(seed), cfg), device, dtype)


# =================================================================== blocks

def _wn_conv(p, x, **kw):
    return layers.weight_norm_conv1d(p, x, **kw)


def wn_conv_transpose(p, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """Weight-normalised ConvTranspose1d: weight_v (I/g, O, K), the norm per
    input channel over (O, K), weight_g broadcast as stored."""
    q = {"weight": layers.weight_norm(p["weight_v"], p["weight_g"], (1, 2)).to(x.dtype)}
    if "bias" in p:
        q["bias"] = p["bias"]
    return layers.conv_transpose1d(q, x, stride=stride, padding=padding)


def adain(p, x: torch.Tensor, s: torch.Tensor, valid_len) -> torch.Tensor:
    """AdaIN1d: the masked instance norm with a style-conditioned affine.
    x (B, T, C), s (B, style)."""
    gamma, beta = layers.linear(p["fc"], s).chunk(2, dim=-1)
    normed = layers.masked_instance_norm(x, valid_len)
    return (1 + gamma[:, None, :]) * normed + beta[:, None, :]


def ada_layer_norm(p, x: torch.Tensor, s: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """AdaLayerNorm: a per-frame LayerNorm over channels, no affine of its
    own, with a style-conditioned one."""
    gamma, beta = layers.linear(p["fc"], s).chunk(2, dim=-1)
    normed = layers.layer_norm(None, x, eps)
    return (1 + gamma[:, None, :]) * normed + beta[:, None, :]


def adain_res_blk1d(p, cfg: KokoroConfig, x: torch.Tensor, s: torch.Tensor, valid_len,
                    upsample: bool = False):
    """AdainResBlk1d: norm → lrelu → [the transposed `pool`, 2× (2T − 1
    frames, one zero frame on the left)] → conv → norm → lrelu → conv, plus
    the [nearest-2× + 1×1] shortcut, over √2. Returns (y, the new valid
    length)."""
    out_valid = valid_len * 2 if upsample else valid_len
    h = layers.leaky_relu(adain(p["norm1"], x, s, valid_len), LRELU_SLOPE)
    if upsample:
        h = wn_conv_transpose(p["pool"], h, stride=2, padding=1)  # 2T − 1
        h = F.pad(h, (0, 0, 1, 0))  # left pad → 2T
        h = layers.zero_pad_tail(h, out_valid)
    h = _wn_conv(p["conv1"], h, padding=1)
    h = layers.leaky_relu(adain(p["norm2"], h, s, out_valid), LRELU_SLOPE)
    h = _wn_conv(p["conv2"], h, padding=1)
    sc = nearest_2x(x) if upsample else x
    if "conv1x1" in p:
        sc = _wn_conv(p["conv1x1"], sc)
    y = (h + sc) / math.sqrt(2.0)
    return layers.zero_pad_tail(y, out_valid), out_valid


def gen_res_block(p, x: torch.Tensor, s: torch.Tensor, valid_len, dilations=(1, 3, 5),
                  kernel: int = 3) -> torch.Tensor:
    """AdaINResBlock1 with Snake activations, per-channel alphas."""
    for i in range(3):
        i_ = str(i)
        xt = adain(p["adain1"][i_], x, s, valid_len)
        a1 = p["alpha1"][i_]
        xt = xt + (1.0 / a1) * torch.sin(a1 * xt) ** 2
        d = dilations[i]
        xt = _wn_conv(p["convs1"][i_], xt, padding=(kernel * d - d) // 2, dilation=d)
        xt = adain(p["adain2"][i_], xt, s, valid_len)
        a2 = p["alpha2"][i_]
        xt = xt + (1.0 / a2) * torch.sin(a2 * xt) ** 2
        xt = _wn_conv(p["convs2"][i_], xt, padding=(kernel - 1) // 2)
        x = xt + x
    return layers.zero_pad_tail(x, valid_len)


# =================================================================== stages

def bert_duration_features(params, cfg: KokoroConfig, tokens: torch.Tensor,
                           n_tokens) -> torch.Tensor:
    """tokens (1, T) padded ids → d_en (1, T, d_model)."""
    mask = (torch.arange(tokens.shape[1], device=tokens.device) < n_tokens)[None].int()
    seq = albert.forward(params["bert"], cfg.albert, tokens, mask)
    return layers.linear(params["bert_encoder"], seq)


def duration_encode(params, cfg: KokoroConfig, d_en: torch.Tensor, style: torch.Tensor,
                    n_tokens) -> torch.Tensor:
    """DurationEncoder: 3 × (masked BiLSTM → AdaLayerNorm → the style
    concatenated) → (1, T, d_model + style)."""
    p = params["predictor"]["text_encoder"]
    b, t, _ = d_en.shape
    s = style[:, None, :].expand(b, t, style.shape[-1])
    x = layers.zero_pad_tail(torch.cat([d_en, s], dim=-1), n_tokens)
    for i in range(3):
        h = lstm.masked_bilstm(p[f"lstm{i}"], x, n_tokens)
        h = ada_layer_norm(p[f"norm{i}"], h, style)
        x = layers.zero_pad_tail(torch.cat([h, s], dim=-1), n_tokens)
    return x


def duration_sums(params, cfg: KokoroConfig, d: torch.Tensor, n_tokens,
                  speed: float) -> torch.Tensor:
    """d → each token's duration before rounding (1, T): the sum of the
    max_dur sigmoids of duration_proj, over speed."""
    p = params["predictor"]
    x = lstm.masked_bilstm(p["lstm"], d, n_tokens)
    return torch.sigmoid(layers.linear(p["duration_proj"], x)).sum(dim=-1) / speed


def predict_durations(params, cfg: KokoroConfig, d: torch.Tensor, n_tokens,
                      speed: float) -> torch.Tensor:
    """d → frames a token (1, T) int64: `duration_sums` rounded half to
    even, at least 1; padded tokens get 0."""
    dur = torch.clamp(torch.round(duration_sums(params, cfg, d, n_tokens, speed)), min=1).long()
    valid = torch.arange(d.shape[1], device=d.device)[None] < n_tokens
    return torch.where(valid, dur, torch.zeros_like(dur))


def alignment_matrix(durations: torch.Tensor, total_frames: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(1, T) durations → (T, F) one-hot alignment: frame f belongs to the
    token whose cumulative-duration interval holds f; frames past the total
    belong to none."""
    cum = torch.cumsum(durations[0], dim=0)
    starts = torch.cat([cum.new_zeros(1), cum[:-1]])
    f = torch.arange(total_frames, device=durations.device)[None, :]
    return ((f >= starts[:, None]) & (f < cum[:, None])).to(dtype)


def f0n_predict(params, cfg: KokoroConfig, en: torch.Tensor, style: torch.Tensor,
                valid_frames):
    """Prosody: the shared BiLSTM → the F0 and N AdainResBlk stacks (the
    middle block upsamples 2×) → 1-wide projections. en (1, F, d + style)
    → (F0 (1, 2F), N (1, 2F), the valid length 2·valid_frames)."""
    p = params["predictor"]
    x = lstm.masked_bilstm(p["shared"], en, valid_frames)

    def branch(blocks, proj):
        h, v = adain_res_blk1d(blocks["0"], cfg, x, style, valid_frames)
        h, v = adain_res_blk1d(blocks["1"], cfg, h, style, v, upsample=True)
        h, v = adain_res_blk1d(blocks["2"], cfg, h, style, v)
        return layers.conv1d(proj, h)[..., 0], v

    f0, v2 = branch(p["F0"], p["F0_proj"])
    n, _ = branch(p["N"], p["N_proj"])
    return f0, n, v2


def text_encode(params, cfg: KokoroConfig, tokens: torch.Tensor, n_tokens) -> torch.Tensor:
    """TextEncoder: embedding → depth × (wn-conv k5 → LayerNorm → lrelu) →
    the masked BiLSTM → (1, T, d_model)."""
    p = params["text_encoder"]
    x = layers.zero_pad_tail(layers.embedding(p["embedding"], tokens), n_tokens)
    pad = (cfg.text_encoder_kernel - 1) // 2
    for i in range(cfg.text_encoder_depth):
        blk = p["cnn"][str(i)]
        x = _wn_conv(blk["conv"], x, padding=pad)
        x = layers.leaky_relu(layers.layer_norm(blk["norm"], x), LRELU_SLOPE)
        x = layers.zero_pad_tail(x, n_tokens)
    return lstm.masked_bilstm(p["lstm"], x, n_tokens)


# =================================================================== generator

def kokoro_stft(x: torch.Tensor, n_fft: int, hop: int):
    """Centred magnitude and phase STFT of (B, T), periodic Hann, in f32 →
    ((B, frames, K), (B, frames, K)). The +0.0 turns −0.0 imaginary parts
    (DC and Nyquist) into +0.0, so atan2 takes the +π branch as the JAX
    module's does."""
    spec = stft_ops.stft_complex(x, windows.hann(n_fft, periodic=True), n_fft, hop, center=True)
    return spec.abs(), torch.atan2(spec.imag + 0.0, spec.real)


def kokoro_istft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Overlap-add inverse: each frame's irfft × the window, over the
    window's own overlap-add (not its square), trimmed by n_fft/2 at both
    ends → (B, samples)."""
    win_np = windows.hann(n_fft, periodic=True)
    win = torch.as_tensor(win_np, dtype=mag.dtype, device=mag.device)
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    nf = frames.shape[1]
    out_len = (nf - 1) * hop + n_fft
    out = stft_ops.overlap_add(frames, hop)
    wsum = np.zeros(out_len)
    for f in range(nf):
        wsum[f * hop: f * hop + n_fft] += win_np
    scale = np.where(wsum != 0, 1.0 / np.maximum(wsum, 1e-30), 1.0)
    out = out * torch.as_tensor(scale, dtype=out.dtype, device=out.device)
    return out[:, n_fft // 2: out_len - n_fft // 2]


def sine_source(params, cfg: KokoroConfig, f0_up: torch.Tensor,
                rng: torch.Generator | None = None,
                rand_ini: torch.Tensor | None = None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """The harmonic NSF source: per-harmonic sines at a random initial
    phase (harmonic 0 at 0), voiced above voiced_threshold, σ 0.003 noise
    where voiced and 0.1/3 where not, merged by a linear and tanh. f0_up
    (B, T, 1) at the sample rate → (B, T, 1). rand_ini (B, H+1) and noise
    (B, T, H+1), where not injected, are drawn from `rng` in that
    order."""
    b, t, _ = f0_up.shape
    h, dt, dev = cfg.harmonic_num + 1, f0_up.dtype, f0_up.device
    upsample_scale = float(np.prod(cfg.upsample_rates) * cfg.istft_hop)
    harmonics = torch.arange(1, h + 1, dtype=dt, device=dev)
    rad = torch.remainder(f0_up * harmonics[None, None, :] / cfg.sample_rate, 1.0)
    if rand_ini is None:
        rand_ini = torch.randn((b, h), generator=rng, device=dev).to(dt)
        rand_ini[:, 0] = 0.0
    rad = torch.cat([rad[:, :1] + rand_ini.to(dt)[:, None], rad[:, 1:]], dim=1)
    # the phase increments down to the frame rate, integrated, and back up
    down = linear_resize(rad, int(t / upsample_scale))
    phase = torch.cumsum(down, dim=1) * 2 * math.pi
    phase = linear_resize(phase * upsample_scale, t)
    sines = torch.sin(phase) * 0.1
    uv = (f0_up > cfg.voiced_threshold).to(dt)
    noise_amp = uv * 0.003 + (1 - uv) * 0.1 / 3
    if noise is None:
        noise = torch.randn(sines.shape, generator=rng, device=dev).to(dt)
    sine_waves = sines * uv + noise_amp * noise.to(dt)
    return torch.tanh(layers.linear(params["m_source"]["l_linear"], sine_waves))


def source_spectrum(params, cfg: KokoroConfig, f0_curve: torch.Tensor,
                    rng: torch.Generator | None = None, rand_ini=None,
                    noise=None) -> torch.Tensor:
    """The generator's source spectrum: F0 (1, 2F) upsampled by nearest
    repetition to the sample rate → `sine_source` → `kokoro_stft` → [mag |
    phase] (1, frames, n_fft + 2), in f32."""
    gp = params["decoder"]["generator"]
    up_total = int(np.prod(cfg.upsample_rates)) * cfg.istft_hop
    f0_up = torch.repeat_interleave(f0_curve[..., None], up_total, dim=1)
    source = sine_source(gp, cfg, f0_up, rng, rand_ini, noise)[..., 0]
    mag, phase = kokoro_stft(source, cfg.istft_n_fft, cfg.istft_hop)
    return torch.cat([mag, phase], dim=-1)


def generator(params, cfg: KokoroConfig, x: torch.Tensor, style: torch.Tensor, valid_frames,
              har: torch.Tensor) -> torch.Tensor:
    """The iSTFT-NSF generator: x (1, 2F, 512) and the source spectrum
    `har` (`source_spectrum`, or one injected in its place) → audio (1,
    samples)."""
    gp = params["decoder"]["generator"]
    n_fft, hop, rates = cfg.istft_n_fft, cfg.istft_hop, cfg.upsample_rates
    har = har.to(x.dtype)
    valid = valid_frames
    n_kernels = len(cfg.resblock_kernels)
    for i, (u, k) in enumerate(zip(rates, cfg.upsample_kernels)):
        x = layers.leaky_relu(x, 0.1)
        last = i + 1 == len(rates)
        if not last:
            stride_f0 = int(np.prod(rates[i + 1:]))
            x_source = layers.conv1d(gp["noise_convs"][str(i)], har, stride=stride_f0,
                                     padding=(stride_f0 + 1) // 2)
        else:
            x_source = layers.conv1d(gp["noise_convs"][str(i)], har)
        x = wn_conv_transpose(gp["ups"][str(i)], x, stride=u, padding=(k - u) // 2)
        valid = valid * u
        if last:  # one reflected frame on the left
            x = F.pad(x.transpose(1, 2), (1, 0), mode="reflect").transpose(1, 2)
            valid = valid + 1
        t = min(x.shape[1], x_source.shape[1])
        # the noise blocks are k7 (k11 at the last stage) with dilations
        # (1, 3, 5), whatever the resblock config
        x_source = gen_res_block(gp["noise_res"][str(i)], x_source[:, :t], style, valid,
                                 (1, 3, 5), 11 if last else 7)
        x = x[:, :t] + x_source
        xs = None
        for j in range(n_kernels):
            r = gen_res_block(gp["resblocks"][str(i * n_kernels + j)], x, style, valid,
                              cfg.resblock_dilations[j], cfg.resblock_kernels[j])
            xs = r if xs is None else xs + r
        x = xs / n_kernels
    x = _wn_conv(gp["conv_post"], layers.leaky_relu(x, 0.01), padding=3)
    k = n_fft // 2 + 1
    return kokoro_istft(torch.exp(x[..., :k]), torch.sin(x[..., k:]), n_fft, hop)


def decode(params, cfg: KokoroConfig, asr: torch.Tensor, f0_curve: torch.Tensor,
           n_curve: torch.Tensor, style: torch.Tensor, valid_frames,
           har: torch.Tensor) -> torch.Tensor:
    """KokoroDecoder: F0 and N downsampled 2×, the encode block, four decode
    blocks conditioned on [asr_res, F0, N] (the last upsamples 2× and ends
    the conditioning), then the generator on the source spectrum `har` →
    audio (1, samples)."""
    dp = params["decoder"]
    f0 = _wn_conv(dp["F0_conv"], f0_curve[..., None], stride=2, padding=1)
    n = _wn_conv(dp["N_conv"], n_curve[..., None], stride=2, padding=1)
    x, _ = adain_res_blk1d(dp["encode"], cfg, torch.cat([asr, f0, n], dim=-1), style,
                           valid_frames)
    asr_res = _wn_conv(dp["asr_res"]["0"], asr)
    res, valid = True, valid_frames
    for i in range(4):
        if res:
            x = torch.cat([x, asr_res, f0, n], dim=-1)
        upsample = i == 3
        x, valid = adain_res_blk1d(dp["decode"][str(i)], cfg, x, style, valid, upsample=upsample)
        if upsample:
            res = False
    return generator(params, cfg, x, style, valid, har)
