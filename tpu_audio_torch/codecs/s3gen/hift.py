"""HiFT-Net vocoder: mel → F0 → harmonic NSF source → iSTFT synthesis
(port of tpu_audio/codecs/s3gen/hift.py: HiFTConfig, init_params,
f0_predict, sine_source, decode, generate, LOOKBACK_FRAMES,
vocode_window).

The F0 predictor (5 × conv k3 + ELU → |linear|) → the sine source at 24 kHz
(9 harmonics integrated from the F0 upsampled × 480, voiced above 10 Hz,
noise σ 0.003 voiced / α/3 unvoiced, a linear + tanh merge) → its STFT
(n_fft 16, hop 4, periodic Hann, centred) fused into the upsampling stack
(rates 8/5/3, kernels 16/11/7; Snake resblocks, the alpha's magnitude
floored at 1e-4 with its sign kept) → exp magnitude / sin phase → iSTFT →
clip ±0.99. The random draws (`rand_ini`, the per-sample noise) come from
a `noise.Noise`-like source, the noise keyed by the absolute mel frame;
`vocode_window` carries the sine phase and the lookback's source samples,
so a chain of windows reproduces `generate` sample for sample.
Convolutions are `F.conv1d` / `F.conv_transpose1d`: the JAX package runs
no Pallas kernel here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs.s3gen.params import Init
from tpu_audio_torch.nn import layers
from tpu_audio_torch.ops import stft as stft_ops
from tpu_audio_torch.ops import windows


@dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: tuple = (8, 5, 3)
    upsample_kernels: tuple = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernels: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernels: tuple = (7, 7, 11)
    source_resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99

    @property
    def upsample_scale(self) -> int:
        s = self.istft_hop
        for r in self.upsample_rates:
            s *= r
        return s  # samples a mel frame (480)


def numpy_params(rng: np.random.Generator, cfg: HiFTConfig) -> dict:
    """The JAX `init_params` tree (JAX layouts) as f32 numpy arrays."""
    init, bc, nfft = Init(rng), cfg.base_channels, cfg.istft_n_fft

    def res_block(ch, kernel, dils):
        n = len(dils)
        return {"convs1": {str(i): init.conv(ch, ch, kernel) for i in range(n)},
                "convs2": {str(i): init.conv(ch, ch, kernel) for i in range(n)},
                "activations1": {str(i): {"alpha": np.ones(ch, np.float32)} for i in range(n)},
                "activations2": {str(i): {"alpha": np.ones(ch, np.float32)} for i in range(n)}}

    n_up = len(cfg.upsample_rates)
    p = {"m_source": {"l_linear": init.linear(cfg.nb_harmonics + 1, 1)},
         "conv_pre": init.conv(cfg.in_channels, bc, 7),
         "ups": {str(i): init.conv(bc >> i, bc >> (i + 1), k)
                 for i, k in enumerate(cfg.upsample_kernels)},
         "source_downs": {}, "source_resblocks": {}, "resblocks": {},
         "conv_post": init.conv(bc >> n_up, nfft + 2, 7),
         "f0_predictor": {"condnet": {str(i): init.conv(cfg.in_channels if i == 0 else 512,
                                                        512, 3) for i in range(5)},
                          "classifier": init.linear(512, 1)}}
    cum, c = [], 1
    for r in [1] + list(reversed(cfg.upsample_rates))[:-1]:
        c *= r
        cum.append(c)
    for i, u in enumerate(reversed(cum)):
        ch = bc >> (i + 1)
        p["source_downs"][str(i)] = init.conv(nfft + 2, ch, 1 if u == 1 else u * 2)
        p["source_resblocks"][str(i)] = res_block(ch, cfg.source_resblock_kernels[i],
                                                  cfg.source_resblock_dilations[i])
    for i in range(n_up):
        for j, (k, d) in enumerate(zip(cfg.resblock_kernels, cfg.resblock_dilations)):
            p["resblocks"][str(i * len(cfg.resblock_kernels) + j)] = res_block(bc >> (i + 1), k, d)
    return p


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + sin²(αx)/α', α' = α's magnitude floored at 1e-4 with its sign
    (+ where α ≈ 0), in f32."""
    a = alpha.float()
    sign = torch.where(a.abs() < 1e-9, torch.ones_like(a), torch.sign(a))
    a_c = sign * torch.clamp(a.abs(), min=1e-4)
    xf = x.float()
    return (xf + torch.sin(xf * a) ** 2 / a_c).to(x.dtype)


def _res_block(p, x: torch.Tensor, kernel: int, dilations) -> torch.Tensor:
    for i, d in enumerate(dilations):
        i_ = str(i)
        xt = snake(x, p["activations1"][i_]["alpha"])
        xt = layers.conv1d(p["convs1"][i_], xt, padding=(kernel * d - d) // 2, dilation=d)
        xt = snake(xt, p["activations2"][i_]["alpha"])
        x = x + layers.conv1d(p["convs2"][i_], xt, padding=(kernel - 1) // 2)
    return x


def f0_predict(p, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, 80) → F0 (B, T)."""
    x = mel
    for i in range(5):
        x = F.elu(layers.conv1d(p["condnet"][str(i)], x, padding=1))
    return torch.abs(layers.linear(p["classifier"], x))[..., 0]


def sine_source(p, cfg: HiFTConfig, f0_up: torch.Tensor, noise, *, start_frame: int = 0,
                init_phase: torch.Tensor | None = None):
    """F0 at the sample rate (B, T, 1) → (the merged harmonic source (B, T,
    1), the end phase (B, H) mod 1, float64). init_phase continues the
    phase of a previous window; start_frame is the absolute mel frame of
    f0_up[:, 0]. The phase is summed in float64, where the JAX module sums
    it in f32."""
    per, h = cfg.upsample_scale, cfg.nb_harmonics + 1
    b = f0_up.shape[0]
    harmonics = torch.arange(1, h + 1, dtype=torch.float32, device=f0_up.device)
    fn = f0_up.float() * harmonics[None, None, :] / cfg.sampling_rate
    # the phase in float64: an f32 cumsum over a window's samples would
    # drift by ~1e-4 of a cycle, and a chain of windows from a full pass
    rad = torch.cumsum(torch.remainder(fn, 1.0).double(), dim=1)
    if init_phase is not None:
        rad = rad + init_phase.double()[:, None, :]
    end_phase = torch.remainder(rad[:, -1, :], 1.0)
    ini = noise.rand_ini(b, h, f0_up.device).double()
    sines = torch.sin(2 * torch.pi * torch.remainder(rad + ini[:, None, :], 1.0)).float()
    uv = (f0_up > cfg.nsf_voiced_threshold).float()
    amp = uv * cfg.nsf_sigma + (1 - uv) * cfg.nsf_alpha / 3
    draws = noise.frames(start_frame, f0_up.shape[1] // per, b, per, h, f0_up.device)
    waves = sines * cfg.nsf_alpha * uv + amp * draws.to(f0_up.device).float()
    return torch.tanh(layers.linear(p["l_linear"], waves.to(f0_up.dtype))), end_phase


def stft(x: torch.Tensor, n_fft: int, hop: int):
    """(real, imag) (B, frames, K) of the centred STFT, periodic Hann."""
    spec = stft_ops.stft_complex(x, windows.hann(n_fft, periodic=True), n_fft, hop)
    return spec.real, spec.imag


def istft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Magnitude (clipped at 100) and phase (B, frames, K) → (B, samples):
    irfft, the window, overlap-add over the squared-window sum, the
    centring trimmed."""
    win_np = windows.hann(n_fft, periodic=True)
    mag = torch.clamp(mag.float(), max=1e2)
    spec = torch.complex(mag * torch.cos(phase.float()), mag * torch.sin(phase.float()))
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * torch.as_tensor(win_np, device=mag.device)
    nf = frames.shape[1]
    out_len = (nf - 1) * hop + n_fft
    wsq = np.maximum(stft_ops.window_sumsquare(win_np, nf, hop, n_fft), 1e-11)
    out = stft_ops.overlap_add(frames, hop) / torch.as_tensor(wsq, dtype=torch.float32,
                                                              device=mag.device)
    return out[:, n_fft // 2: out_len - n_fft // 2]


def decode(params, cfg: HiFTConfig, mel: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """mel (B, T, 80) + source (B, T·480) → waveform (B, T·480) f32."""
    sr, si_ = stft(source, cfg.istft_n_fft, cfg.istft_hop)
    s_stft = torch.cat([sr, si_], dim=-1).to(mel.dtype)
    x = layers.conv1d(params["conv_pre"], mel, padding=3)
    n_up, nk = len(cfg.upsample_rates), len(cfg.resblock_kernels)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        x = F.leaky_relu(x, cfg.lrelu_slope)
        x = layers.conv_transpose1d(params["ups"][str(i)], x, stride=u, padding=(k - u) // 2)
        if i == n_up - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)  # reflect pad left 1
        sd = params["source_downs"][str(i)]
        down_k = sd["weight"].shape[-1]
        if down_k == 1:
            si = layers.conv1d(sd, s_stft)
        else:
            stride = down_k // 2
            si = layers.conv1d(sd, s_stft, stride=stride, padding=stride // 2)
        si = _res_block(params["source_resblocks"][str(i)], si, cfg.source_resblock_kernels[i],
                        cfg.source_resblock_dilations[i])
        t = min(x.shape[1], si.shape[1])
        x = x[:, :t] + si[:, :t]
        xs = None
        for j in range(nk):
            r = _res_block(params["resblocks"][str(i * nk + j)], x, cfg.resblock_kernels[j],
                           cfg.resblock_dilations[j])
            xs = r if xs is None else xs + r
        x = xs / nk
    x = layers.conv1d(params["conv_post"], F.leaky_relu(x, cfg.lrelu_slope), padding=3)
    k = cfg.istft_n_fft // 2 + 1
    audio = istft(torch.exp(x[..., :k].float()), torch.sin(x[..., k:].float()),
                  cfg.istft_n_fft, cfg.istft_hop)
    return torch.clamp(audio, -cfg.audio_limit, cfg.audio_limit)


def generate(params, cfg: HiFTConfig, mel: torch.Tensor, noise,
             cache_source: torch.Tensor | None = None):
    """The whole vocoder pass: (audio (B, T·480), source (B, T·480))."""
    f0 = f0_predict(params["f0_predictor"], mel)
    f0_up = f0[..., None].repeat_interleave(cfg.upsample_scale, dim=1)
    source = sine_source(params["m_source"], cfg, f0_up, noise)[0][..., 0]
    if cache_source is not None and cache_source.shape[1] > 0:
        n = cache_source.shape[1]
        source = torch.cat([cache_source.to(source.dtype), source[:, n:]], dim=1)
    return decode(params, cfg, mel, source), source


LOOKBACK_FRAMES = 32  # > the stack's receptive field (~15 mel frames)


def vocode_window(params, cfg: HiFTConfig, mel: torch.Tensor, noise, phase: torch.Tensor,
                  source_tail: torch.Tensor, start_frame: int):
    """One streaming window: mel (B, Lb + N, 80), its first Lb frames the
    lookback whose source samples are `source_tail` (B, Lb · 480), the
    sine phase at the first new frame `phase` (B, H), start_frame the
    absolute index of that frame. Returns (audio (B, (Lb + N)·480), the
    new phase, the window's source (B, (Lb + N)·480))."""
    per = cfg.upsample_scale
    lb = source_tail.shape[1] // per
    f0 = f0_predict(params["f0_predictor"], mel)
    f0_up = f0[:, lb:, None].repeat_interleave(per, dim=1)
    src_new, new_phase = sine_source(params["m_source"], cfg, f0_up, noise,
                                     start_frame=start_frame, init_phase=phase)
    source = torch.cat([source_tail.to(src_new.dtype), src_new[..., 0]], dim=1)
    return decode(params, cfg, mel, source), new_phase, source
