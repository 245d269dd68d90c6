"""Group-affine q4/q8 dequant-matmul (the MLX checkpoint format) at ≤ 32
rows: y = x · (q · s + b)ᵀ in f32.

Replaces the TPU kernel tpu_audio/ops/pallas/quant_matmul.py:quant_matmul
with `csrc/quant_matmul.cu`. The TPU kernel's nibble planes and its 0/1
expansion matmul for the group scales are Mosaic devices; here each lane
unpacks the codes of its own 16-byte vector of words and folds the group's
affine in as s · Σ x q + b · Σ x.

Bound on the H100: device-memory bytes, 0.5 (q4) or 1 (q8) byte a weight
plus 8 bytes of scale and bias per 64 weights; at Qwen3-0.6B's tied lm head
97.2 MB a call. Design in the .cu: one warp per output channels, 16-byte
cache-streaming loads, the codes turned into floats without the converter,
activations staged transposed in shared memory, rows in passes of 8.

The packed words are int32 tensors holding the uint32 bits (torch has few
uint32 operations); `unpack_words` masks the sign extension off.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_audio_torch.ops.kernels import _build

MAX_ROWS = 32   # the weight-streaming regime; more rows take the dequantised product
GROUP = 64      # the group size the kernel takes

LAUNCHES = {"quant_matmul": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel("tpa_quant_matmul", _P, _P, _P, _P, _P, _I, _I, _I, _I)


def unpack_words(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(…, W) words (int32 or int64 with the uint32 bits) → (…, W·32/bits)
    int32 codes in [0, 2^bits), low bits first."""
    per = 32 // bits
    shifts = torch.arange(per, device=packed.device, dtype=torch.int64) * bits
    vals = (packed.to(torch.int64)[..., None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*packed.shape[:-1], packed.shape[-1] * per).to(torch.int32)


def dequantize_words(packed: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """(…, O, W) words with (…, O, G) scales and biases → (…, O, I) f32."""
    q = unpack_words(packed, bits).float()
    group = q.shape[-1] // scales.shape[-1]
    return (q * scales.float().repeat_interleave(group, dim=-1)
            + biases.float().repeat_interleave(group, dim=-1))


def quant_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                       biases: torch.Tensor, *, bits: int = 4) -> torch.Tensor:
    """Plain PyTorch version of `quant_matmul`."""
    return x.float() @ dequantize_words(packed, scales, biases, bits).T


def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 biases: torch.Tensor, *, bits: int = 4) -> torch.Tensor:
    """x (B, I) float · dequant(packed (O, I·bits/32), scales and biases
    (O, I/64))ᵀ → (B, O) f32.

    On CUDA: 1 ≤ B ≤ 32, bits 4 or 8, group 64, packed int32, scales and
    biases f32, all contiguous; x is cast to f32, as the TPU kernel does."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, packed, scales, biases, bits=bits)
    device = _build.require_cuda("quant_matmul", x, packed, scales, biases)
    if x.dim() != 2 or bits not in (4, 8):
        raise ValueError(f"quant_matmul: x must be (B, I) and bits 4 or 8, got "
                         f"{tuple(x.shape)}, bits {bits}")
    b, i = x.shape
    o = packed.shape[0]
    if not 1 <= b <= MAX_ROWS or i % GROUP:
        raise ValueError(f"quant_matmul: unsupported rows={b} or in_features={i}")
    _build.check("quant_matmul packed", packed, torch.int32, (o, i * bits // 32))
    _build.check("quant_matmul scales", scales, torch.float32, (o, i // GROUP))
    _build.check("quant_matmul biases", biases, torch.float32, (o, i // GROUP))
    xf = x.float().contiguous()
    out = torch.empty((b, o), dtype=torch.float32, device=device)
    _KERNEL(device, xf, packed, scales, biases, out, b, i, o, bits)
    LAUNCHES["quant_matmul"] += 1
    return out
