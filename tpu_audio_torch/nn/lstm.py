"""LSTM and BiLSTM over time (port of tpu_audio/nn/lstm.py: lstm, bilstm,
masked_bilstm).

PyTorch's gate order i, f, g, o. Parameters a direction:
{"wx" (4H, D), "wh" (4H, H), "bias_ih" (4H,), "bias_hh" (4H,)}; the two
biases are summed. The input projection runs once over all frames, before
the loop over time, as the JAX module hoists it out of its scan; the loop
is plain torch, one step a frame. The Chatterbox voice encoder runs three
layers; Kokoro's duration and prosody predictors run the BiLSTMs.
"""

from __future__ import annotations

import torch


def lstm(p: dict, x: torch.Tensor, reverse: bool = False, h0: torch.Tensor | None = None,
         c0: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, T, D) → outputs (B, T, H); reverse runs from the last frame
    back (outputs stay at their frames)."""
    b, t, _ = x.shape
    hdim = p["wh"].shape[1]
    h = x.new_zeros((b, hdim)) if h0 is None else h0
    c = x.new_zeros((b, hdim)) if c0 is None else c0
    bias = 0
    if "bias_ih" in p:
        bias = p["bias_ih"]
    if "bias_hh" in p:
        bias = bias + p["bias_hh"]
    xw = x @ p["wx"].T.to(x.dtype)
    if isinstance(bias, torch.Tensor):
        xw = xw + bias.to(x.dtype)
    wh = p["wh"].T.to(x.dtype)
    out = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        gates = xw[:, s] + h @ wh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[s] = h
    return torch.stack(out, dim=1)


def bilstm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """p {"fwd": …, "bwd": …} → (B, T, 2H)."""
    return torch.cat([lstm(p["fwd"], x), lstm(p["bwd"], x, reverse=True)], dim=-1)


def masked_bilstm(p: dict, x: torch.Tensor, valid_len) -> torch.Tensor:
    """BiLSTM over (B, T, C) whose first valid_len frames are real: the
    backward direction starts from the last valid frame (the valid region
    reversed by a gather before and after a forward pass), and the frames
    past valid_len come out zero."""
    t = x.shape[1]
    ar = torch.arange(t, device=x.device)
    valid = ar < valid_len
    fwd = lstm(p["fwd"], x)
    flip = torch.where(valid, valid_len - 1 - ar, ar)
    bwd = lstm(p["bwd"], x[:, flip])[:, flip]
    out = torch.cat([fwd, bwd], dim=-1)
    return torch.where(valid[None, :, None], out, torch.zeros_like(out))
