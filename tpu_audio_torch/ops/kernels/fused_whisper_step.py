"""The whole Whisper decoder step at B=1, T=1, all layers in one launch.

Replaces the TPU kernel
tpu_audio/ops/pallas/fused_whisper_step.py:fused_whisper_decode_step with
`csrc/fused_whisper_step.cu`.

Per layer: LN → q/k/v → self-attention over the cached positions < pos
plus the current token's own term (its K/V slot is written into the cache
in place) → o-projection + residual → LN → cross-attention over the int8
cross-K/V (the K scale folded into q, the V scale into the output) →
o-projection + residual → LN → fc1 + erf-GELU → fc2 + residual; then the
final LN. Weights are per-channel int8 with an f32 scale, or bf16 (scale
1). `hn` is rounded to the activation dtype (x's) before every product, as
the TPU kernel does; the sums are f32.

Bound on the H100: issue, then bytes. The per-layer path issues ~150
small launches per step, each with microseconds of host cost, while the
bytes of a step at large-v3-turbo (91.8 MB of int8 decoder weights, 15.4 MB
of cross-K/V, ≤ 9.2 MB of bf16 self cache) need ~35 µs at 3.35 TB/s.
Design: one cooperative launch of co-resident blocks; grid-wide barriers
separate the dependent phases (q/k/v, self-attention, o-projection,
cross-q, cross-attention, cross-o, fc1, fc2). Each block computes a
contiguous share of every product's rows, copied into shared memory during
the product and the barrier before it; each attention splits a head's
keys over several blocks (`chunk_bounds`), and the block whose chunk
finishes last merges the head's (max, sum, P·V) partials
(`self_attention_chunks`, `cross_attention_chunks` are that partition and
merge in PyTorch): one pass a chunk with f32 activations, two with bf16
ones, whose probabilities are rounded against the head's max and sum like
the reference's.

The plain version is the same step layer by layer in PyTorch, with the
TPU kernel's rounding. It returns the final-LN h and writes the slot.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.ops.kernels.cross_kv_attention import attend_chunks, chunk_bounds

HEAD_DIM = 64      # the kernel is compiled for hd = 64
MAX_SPLIT = 32     # key chunks per head, at most (the .cu's kMaxSplit)
MAX_D = 2048       # the widest residual a block's LayerNorm holds (the .cu's 8 x 256)
NAMES = ("q", "k", "v", "o", "qc", "oc", "fc1", "fc2")
_LEAVES = {"q": ("attn", "q"), "k": ("attn", "k"), "v": ("attn", "v"),
           "o": ("attn", "o"), "qc": ("cross_attn", "q"),
           "oc": ("cross_attn", "o"), "fc1": ("mlp", "fc1"),
           "fc2": ("mlp", "fc2")}

LAUNCHES = {"fused_whisper_decode_step": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel("tpa_fused_whisper_step", _P, _I, _P,
                        *(_P,) * 8, *(_P,) * 8, *(_P,) * 8, _P, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I)
_PLAN = _build.Kernel("tpa_fused_whisper_step_plan", *(_I,) * 8, _P)


def step_vectors(dec) -> dict:
    """The decoder's small per-layer vectors in f32, computed once per
    model: "ln" (L, 3, 2, D) = (ln1, ln_cross, ln2) × (weight, bias),
    "lnf" (2, D), and "bias_<name>" (L, O) for every linear with a bias."""
    blocks = dec["blocks"]
    out = {"ln": torch.stack([torch.stack([blocks[n]["weight"].float(),
                                           blocks[n]["bias"].float()], 1)
                              for n in ("ln1", "ln_cross", "ln2")], 1),
           "lnf": torch.stack([dec["ln"]["weight"].float(),
                               dec["ln"]["bias"].float()])}
    for name, (a, b) in _LEAVES.items():
        if "bias" in blocks[a][b]:
            out[f"bias_{name}"] = blocks[a][b]["bias"].float().contiguous()
    return out


def decoder_supported(blocks) -> bool:
    """Whether the step reads this decoder's weights: every linear it reads
    fp, or every one int8 (group-affine q4/q8 and mixed decoders take the
    per-layer path)."""
    leaves = [blocks[a][b] for a, b in _LEAVES.values()]
    return any(all(key in p for p in leaves) for key in ("weight", "weight_i8"))


@dataclass
class StepWeights:
    """What the step reads, by `NAMES`: stacked (L, O, I) weights, int8 or
    fp; their (L, O) f32 scales (None for fp weights); `step_vectors`."""

    w: dict
    scale: dict | None
    vec: dict

    @staticmethod
    def of(dec, vec: dict | None = None) -> "StepWeights":
        """From a decoder tree (views, no copies) and its `step_vectors`."""
        blocks = dec["blocks"]
        leaves = {n: blocks[a][b] for n, (a, b) in _LEAVES.items()}
        int8 = "weight_i8" in leaves["q"]
        w = {n: leaf["weight_i8" if int8 else "weight"] for n, leaf in leaves.items()}
        scale = ({n: leaf["scale_i8"].reshape(leaf["scale_i8"].shape[:2])
                  for n, leaf in leaves.items()} if int8 else None)
        return StepWeights(w, scale, step_vectors(dec) if vec is None else vec)


# --------------------------------------------------------------- plain

def _layer_norm(x, wb, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], wb[0], wb[1], eps)


def _final_norm(x, wb):
    return _layer_norm(x, wb)


def _self_attention(q, k, v, k_hist, v_hist, rnd):
    """q, k, v (H, hd) f32 of the current token; k_hist, v_hist (pos, H,
    hd) f32 → (H, hd): softmax over the history and the fresh term."""
    s_hist = torch.einsum("thd,hd->ht", k_hist, q)
    s_fresh = (q * k).sum(-1)
    m = torch.maximum(s_hist.amax(-1), s_fresh) if k_hist.shape[0] else s_fresh
    e_hist = torch.exp(s_hist - m[:, None])
    e_fresh = torch.exp(s_fresh - m)
    den = e_hist.sum(-1) + e_fresh
    out = torch.einsum("ht,thd->hd", rnd(e_hist / den[:, None]), rnd(v_hist))
    return out + (e_fresh / den)[:, None] * v


def _cross_attention(qs, k8, v8, vsc, t_valid: int, rnd):
    """qs (H, hd) with the K scale folded in; k8, v8 (T_pad, H, hd) int8;
    vsc (H, hd) → (H, hd)."""
    s = torch.einsum("thd,hd->ht", k8[:t_valid].float(), qs)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("ht,thd->hd", rnd(p), v8[:t_valid].float()) * vsc


def self_attention_chunks(q, k, v, k_hist, v_hist, rnd, *, split: int, rb: bool,
                          drop_sum: int | None = None, drop_chunk: int | None = None):
    """`_self_attention` as the kernel computes it: the history's positions
    in `split` chunks, merged with the fresh term by `attend_chunks`, one
    pass a chunk unless `rb` (bf16 activations: `rnd` rounds)."""
    s = torch.einsum("thd,hd->ht", k_hist, q)
    return attend_chunks(s, v_hist, split, s_fresh=(q * k).sum(-1), v_fresh=v,
                         rnd=rnd if rb else None, drop_sum=drop_sum, drop_chunk=drop_chunk)


def cross_attention_chunks(qs, k8, v8, vsc, t_valid: int, rnd, *, split: int, rb: bool,
                           drop_sum: int | None = None, drop_chunk: int | None = None):
    """`_cross_attention` as the kernel computes it: the t_valid keys in
    `split` chunks merged by `attend_chunks`, one pass a chunk unless `rb`."""
    s = torch.einsum("thd,hd->ht", k8[:t_valid].float(), qs)
    return attend_chunks(s, v8[:t_valid].float(), split, rnd=rnd if rb else None,
                         drop_sum=drop_sum, drop_chunk=drop_chunk) * vsc


def _mlp(hn, proj, rnd, layer: int):
    return proj("fc2", layer, rnd(F.gelu(proj("fc1", layer, hn))))


def fused_whisper_decode_step_plain(sw: StepWeights, x, pos, k_cache, v_cache,
                                    k8, ksc, v8, vsc, *, n_heads: int,
                                    t_valid: int) -> torch.Tensor:
    """Plain PyTorch version of `fused_whisper_decode_step`."""
    cd = x.dtype
    lyr, _, d = k_cache.shape
    hd = d // n_heads
    scale = hd ** -0.25
    p = int(pos)

    def rnd(a):
        return a.to(cd).float()

    def proj(name, layer, a):
        y = a @ rnd(sw.w[name][layer]).T
        if sw.scale is not None:
            y = y * sw.scale[name][layer]
        bias = sw.vec.get(f"bias_{name}")
        return y if bias is None else y + bias[layer]

    def heads(a):
        return a.reshape(*a.shape[:-1], n_heads, hd)

    ln, xs = sw.vec["ln"], x.float().reshape(d)
    for i in range(lyr):
        hn = rnd(_layer_norm(xs, ln[i, 0]))
        q, k, v = proj("q", i, hn) * scale, proj("k", i, hn) * scale, proj("v", i, hn)
        o = _self_attention(heads(q), heads(k), heads(v), heads(k_cache[i, :p].float()),
                            heads(v_cache[i, :p].float()), rnd)
        k_cache[i, p] = k.to(k_cache.dtype)
        v_cache[i, p] = v.to(v_cache.dtype)
        xs = xs + proj("o", i, rnd(o.reshape(d)))
        hn = rnd(_layer_norm(xs, ln[i, 1]))
        qs = proj("qc", i, hn) * scale * ksc[i].reshape(d)
        o = _cross_attention(heads(qs), heads(k8[i, 0]), heads(v8[i, 0]),
                             heads(vsc[i].reshape(d)), t_valid, rnd)
        xs = xs + proj("oc", i, rnd(o.reshape(d)))
        xs = xs + _mlp(rnd(_layer_norm(xs, ln[i, 2])), proj, rnd, i)
    return _final_norm(xs, sw.vec["lnf"])[None]


# --------------------------------------------------------------- kernel

def launch_plan(device: torch.device, *, int8: bool, cache_f32: bool, n_layers: int, d: int,
                hidden: int, n_heads: int, s_max: int, t_pad: int) -> dict:
    """The kernel's launch on `device` for these sizes, without launching:
    its blocks (two an SM where they fit), key chunks a head ("split"),
    weight buffers in shared memory and a block's shared-memory bytes."""
    out = torch.zeros(4, dtype=torch.int32)
    _PLAN(device, int(int8), int(cache_f32), n_layers, d, hidden, n_heads, s_max, t_pad, out)
    return dict(zip(("blocks", "split", "buffers", "smem_bytes"), out.tolist()))


def workspace_floats(d: int, hidden: int, n_heads: int) -> int:
    """f32 workspace of one step: residual, q, k, v, cross-q, the merged
    attention output (D each), the fc1 activation, every chunk's (max, sum,
    P·V) and four arrival counters a head (checked by the .cu)."""
    return 6 * d + hidden + n_heads * MAX_SPLIT * (HEAD_DIM + 2) + 4 * n_heads


def fused_whisper_decode_step(sw: StepWeights, x: torch.Tensor, pos: torch.Tensor,
                              k_cache: torch.Tensor, v_cache: torch.Tensor,
                              k8: torch.Tensor, ksc: torch.Tensor, v8: torch.Tensor,
                              vsc: torch.Tensor, *, n_heads: int,
                              t_valid: int) -> torch.Tensor:
    """One decoder step of one token → h (1, D) f32 after the final LN.

    x (1, D): the embedded token plus its position, in the activation
    dtype; pos: 0-d int64 position (the cache's); k_cache, v_cache
    (L, S, H·hd): flat views of the self-attention cache, whose slot `pos`
    is written IN PLACE; k8, v8 (L, 1, T_pad, H·hd) int8 with (L, 1, H·hd)
    f32 scales (`cross_kv_attention.quantize_cross_kv`).

    On CUDA: x f32 or bf16; weights all int8 (with scales) or all bf16;
    the cache bf16 or f32; hd = 64; all contiguous. A cooperative launch
    that the card refuses raises."""
    if x.device.type == "cpu":
        return fused_whisper_decode_step_plain(sw, x, pos, k_cache, v_cache, k8,
                                               ksc, v8, vsc, n_heads=n_heads,
                                               t_valid=t_valid)
    ws = [sw.w[n] for n in NAMES]
    scales = [sw.scale[n] for n in NAMES] if sw.scale is not None else [None] * 8
    biases = [sw.vec.get(f"bias_{n}") for n in NAMES]
    device = _build.require_cuda(
        "fused_whisper_decode_step", x, pos, k_cache, v_cache, k8, ksc, v8, vsc,
        sw.vec["ln"], sw.vec["lnf"], *ws,
        *(t for t in scales + biases if t is not None))
    lyr, s_max, d = k_cache.shape
    hidden = ws[NAMES.index("fc1")].shape[1]
    t_pad = k8.shape[2]
    if d != n_heads * HEAD_DIM or d % 16 or hidden % 16 or d > MAX_D:
        raise ValueError(f"fused_whisper_decode_step: unsupported D={d}, "
                         f"heads={n_heads}, hidden={hidden}")
    if not 1 <= t_valid <= t_pad or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_whisper_decode_step: t_valid={t_valid} or "
                         f"x dtype {x.dtype} unsupported")
    int8 = sw.scale is not None
    wdt = torch.int8 if int8 else torch.bfloat16
    shapes = {"q": (d, d), "k": (d, d), "v": (d, d), "o": (d, d), "qc": (d, d),
              "oc": (d, d), "fc1": (hidden, d), "fc2": (d, hidden)}
    for n, w, s, b in zip(NAMES, ws, scales, biases):
        _build.check(f"fused_whisper_decode_step w_{n}", w, wdt, (lyr, *shapes[n]))
        if s is not None:
            _build.check(f"fused_whisper_decode_step scale_{n}", s, torch.float32,
                         (lyr, shapes[n][0]))
        if b is not None:
            _build.check(f"fused_whisper_decode_step bias_{n}", b, torch.float32,
                         (lyr, shapes[n][0]))
    if biases[NAMES.index("k")] is not None:
        raise ValueError("fused_whisper_decode_step: the k projection has no bias")
    _build.check("fused_whisper_decode_step x", x, x.dtype, (1, d))
    _build.check("fused_whisper_decode_step pos", pos, torch.int64, ())
    _build.check("fused_whisper_decode_step ln", sw.vec["ln"], torch.float32,
                 (lyr, 3, 2, d))
    _build.check("fused_whisper_decode_step lnf", sw.vec["lnf"], torch.float32, (2, d))
    if k_cache.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_whisper_decode_step: cache dtype {k_cache.dtype}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check(f"fused_whisper_decode_step {name}", c, k_cache.dtype, (lyr, s_max, d))
    for name, c, s in (("k8", k8, ksc), ("v8", v8, vsc)):
        _build.check(f"fused_whisper_decode_step {name}", c, torch.int8, (lyr, 1, t_pad, d))
        _build.check(f"fused_whisper_decode_step {name} scale", s, torch.float32, (lyr, 1, d))
    n_work = workspace_floats(d, hidden, n_heads)
    work = torch.empty(n_work, dtype=torch.float32, device=device)
    h = torch.empty((1, d), dtype=torch.float32, device=device)
    _KERNEL(device, x, int(x.dtype == torch.bfloat16), pos, *ws, *scales, *biases,
            sw.vec["ln"], sw.vec["lnf"], k_cache, v_cache, k8, ksc, v8, vsc, h, work,
            n_work, int(int8), int(k_cache.dtype == torch.float32), lyr, d, hidden,
            n_heads, s_max, t_pad, t_valid)
    LAUNCHES["fused_whisper_decode_step"] += 1
    return h
