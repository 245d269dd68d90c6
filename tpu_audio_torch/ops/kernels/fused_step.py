"""The whole Llama / Qwen2 / Qwen3 decoder stack for one token at B=1, all
layers in one launch.

Replaces the TPU kernel tpu_audio/ops/pallas/fused_step.py:fused_decode_step
with `csrc/fused_step.cu`.

Per layer: RMSNorm → fused qkv (× the per-channel scale on the dot's
output, + the optional Qwen2 bias) → the optional Qwen3 per-head q/k RMS →
half-split RoPE from the supplied f32 cos/sin → GQA attention of query head
j over KV head j // (H/KVH), on the cache slots [start, pos) plus the
current token as a fresh term (its k/v slot is written into the cache at
`pos`, in place) → o-projection + residual → RMSNorm → silu(gate) · up →
down + residual; then the final RMSNorm, returned in f32. Weights are fp
(scale 1) or per-channel int8 (W8A16: the codes are cast to the activation
dtype, the activations are not quantised). With bf16 activations the
normed input, the probabilities, the attention output and the SwiGLU
activation are rounded to bf16 before their products, as the TPU kernel
rounds to its compute dtype; the sums are f32.

Bound on the H100: bytes. A step reads every layer's weights once:
Qwen3-0.6B's are 880.8 MB in bf16, 440.4 MB in int8; Llama-3.2-3B's 2.82
GB in int8. Design (in the .cu): one cooperative launch, a block an SM; a
producer warp streams the block's contiguous share of every product's rows
(`row_share`; of gate/up the gate and the up rows of the same channels)
through a ring of bulk copies, past the grid barriers that end each of a
layer's five phases; the products run on the tensor cores (mma.sync)
against the input vector split into exact int8 or bf16 terms, so no weight
is converted; the chunks of a head's keys are merged by the chunk that
arrives last (`attention_chunks` is that partition and merge in PyTorch).
The TPU kernel's plain/grouped layouts, 8-row padding and VMEM budget are
Mosaic devices and have no counterpart.

The plain version is the same step in PyTorch with the TPU kernel's
rounding; `prepare_stack` turns a fused layer tree into what both read.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from tpu_audio_torch.nn import rope
from tpu_audio_torch.ops.kernels import _build
from tpu_audio_torch.ops.kernels.cross_kv_attention import chunk_bounds

HEAD_DIMS = (64, 128)   # the kernel is compiled for these head sizes
MAX_SPLIT = 32          # key chunks per head, at most (the .cu's kMaxSplit)

LAUNCHES = {"fused_decode_step": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel("tpa_fused_step", _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_float,
                        _I, _I, _I, _I, _I, _I, _I, _I)
_PLAN = _build.Kernel("tpa_fused_step_plan", _I, _I, _I, _I, _I, _I, _I, _P)

# the small derived tensors of prepare_stack, per stack, by id of the fused
# qkv weight tensor; an entry goes when that tensor does (the values hold no
# reference to it)
_VECTORS: dict[int, dict] = {}


def _weight_and_scale(leaf: dict):
    if "weight_i8" in leaf:
        w = leaf["weight_i8"]
        return w, leaf["scale_i8"].reshape(w.shape[:-1]).float()
    w = leaf["weight"]
    return w, None


def prepare_stack(params: dict) -> dict:
    """A stacked layer tree with fused "qkv" / "gateup" leaves (fp or int8)
    → what the step reads: "wqkv" (L, QO, D), "wo", "wgateup" (L, 2·hidden,
    D) (gate rows, then up rows), "wdown", their (L, O) f32 scales "sqkv",
    "so", "sgateup", "sdown" (ones for fp weights), "ln1", "ln2" (L, D) and
    "norm" (D) f32, and optionally "bqkv" (L, QO) and "qknorm" (L, 2, hd)
    f32. The weights are the tree's own tensors; the small f32 tensors are
    made once per tree."""
    lp = params["layers"]
    attn, mlp = lp["attn"], lp["mlp"]
    if "qkv" not in attn or "gateup" not in mlp:
        raise ValueError("fused qkv/gateup leaves required (fuse_fp_tree / fuse_int8_tree)")
    if "bias" in attn["o"] or "bias" in mlp["gateup"] or "bias" in mlp["down"]:
        raise ValueError("bias only supported on the qkv projection")
    weights = {}
    for name, leaf in (("qkv", attn["qkv"]), ("o", attn["o"]), ("gateup", mlp["gateup"]),
                       ("down", mlp["down"])):
        weights[name] = _weight_and_scale(leaf)
    key = weights["qkv"][0]
    vec = _VECTORS.get(id(key))
    if vec is None:
        vec = {f"s{n}": (s if s is not None else torch.ones(w.shape[:-1], device=w.device))
               for n, (w, s) in weights.items()}
        vec.update(ln1=lp["ln1"]["weight"].float(), ln2=lp["ln2"]["weight"].float(),
                   norm=params["norm"]["weight"].float())
        if "bias" in attn["qkv"]:  # Qwen2
            vec["bqkv"] = attn["qkv"]["bias"].float()
        if "q_norm" in attn:  # Qwen3: per-head q/k RMS, shared (hd,) weights per layer
            vec["qknorm"] = torch.stack([attn["q_norm"]["weight"], attn["k_norm"]["weight"]],
                                        dim=1).float()
        vec = {k: v.contiguous() for k, v in vec.items()}
        _VECTORS[id(key)] = vec
        weakref.finalize(key, _VECTORS.pop, id(key), None)
    return {**{f"w{n}": w for n, (w, _) in weights.items()}, **vec}


def make_cos_sin(pos: torch.Tensor, inv_freq: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (hd,) cos and sin at the 0-d position tensor `pos`, half-split
    duplicated (ang = pos · inv_freq, concat([ang, ang])), on pos's device."""
    return rope.cos_sin(pos, inv_freq)


# --------------------------------------------------------------- plain

def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def _kv_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(KVH, …) → (H, …): query head j takes KV head j // (H / KVH)."""
    return t.repeat_interleave(n_heads // t.shape[0], dim=0)


def _attention(q, k, v, k_hist, v_hist, rnd):
    """q (H, hd) rotated and scaled, k, v (KVH, hd) f32 of the current
    token; k_hist, v_hist (KVH, T, hd) f32 → (H, hd): softmax over the
    history and the fresh term, probabilities rounded by `rnd`."""
    h = q.shape[0]
    k, v, k_hist, v_hist = (_kv_heads(t, h) for t in (k, v, k_hist, v_hist))
    s_hist = torch.einsum("htd,hd->ht", k_hist, q)
    s_fresh = (q * k).sum(-1)
    m = torch.maximum(s_hist.amax(-1), s_fresh) if k_hist.shape[1] else s_fresh
    e_hist = torch.exp(s_hist - m[:, None])
    e_fresh = torch.exp(s_fresh - m)
    den = e_hist.sum(-1) + e_fresh
    out = torch.einsum("ht,htd->hd", rnd(e_hist / den[:, None]), rnd(v_hist))
    return out + (e_fresh / den)[:, None] * v


def attention_chunks(q, k, v, k_hist, v_hist, rnd, *, split: int, rb: bool, kv_head=None,
                     drop_fresh: bool = False, twice: int | None = None):
    """`_attention` as the kernel computes it: query head j's history (of
    KV head `kv_head(j)`, j // (H / KVH) unless given) split into `split`
    chunks (`chunk_bounds`), each leaving its max m_c, sum l_c of exp(s −
    m_c) and P·V, merged with the current token's own term by the chunk
    that arrives last. f32 (`rb` False): one pass a chunk, P·V = Σ exp(s −
    m_c) v, weighed in the merge by exp(m_c − M) / L. bf16 (`rb`): the
    chunks publish m_c and l_c first, then each probability is rnd(exp(s −
    M) / L), as the unsplit attention rounds it, P·V = Σ p rnd(v), and the
    merge sums them. An empty chunk has sum 0 and is left out. Planted
    faults: `drop_fresh` leaves the current token's term out of the max,
    the sum and the output; `twice` merges chunk `twice` a second time."""
    h, hd = q.shape
    group = h // k.shape[0]
    kv = torch.tensor([j // group if kv_head is None else kv_head(j) for j in range(h)],
                      device=q.device)
    k, v, k_hist, v_hist = k[kv], v[kv], k_hist[kv], v_hist[kv]
    s = torch.einsum("htd,hd->ht", k_hist, q)
    s_fresh = (q * k).sum(-1)
    chunks = []
    for a, b in chunk_bounds(s.shape[1], split):
        if b > a:
            m = s[:, a:b].amax(-1)
            chunks.append((a, b, m, torch.exp(s[:, a:b] - m[:, None]).sum(-1)))
    big_m = torch.full((h,), -torch.inf, device=q.device) if drop_fresh else s_fresh
    for *_, m, _ in chunks:
        big_m = torch.maximum(big_m, m)
    big_l = torch.zeros(h, device=q.device) if drop_fresh else torch.exp(s_fresh - big_m)
    for *_, m, l in chunks:
        big_l = big_l + l * torch.exp(m - big_m)
    parts = []
    for a, b, m, _ in chunks:
        if rb:
            p = rnd(torch.exp(s[:, a:b] - big_m[:, None]) / big_l[:, None])
            parts.append(torch.einsum("ht,htd->hd", p, rnd(v_hist[:, a:b])))
        else:
            e = torch.exp(s[:, a:b] - m[:, None])
            parts.append(torch.einsum("ht,htd->hd", e, v_hist[:, a:b])
                         * (torch.exp(m - big_m) / big_l)[:, None])
    if twice is not None:
        parts.append(parts[twice])
    out = torch.zeros(h, hd, device=q.device)
    for part in parts:
        out = out + part
    if not drop_fresh:
        out = out + (torch.exp(s_fresh - big_m) / big_l)[:, None] * v
    return out


def row_share(channels: int, blocks: int, b: int) -> tuple[int, int]:
    """Block b's output channels [lo, hi) of a product with `channels` of
    them over `blocks` blocks (the .cu's `share`)."""
    return channels * b // blocks, channels * (b + 1) // blocks


def block_rows(product: str, d: int, hidden: int, qo: int, blocks: int, b: int) -> list[range]:
    """The stacked weight rows block b streams for `product` ("qkv", "o",
    "gateup", "down"), one contiguous range a unit: of gate/up the gate rows
    of its channels, then the up rows (`hidden` further) of the same ones."""
    channels = {"qkv": qo, "o": d, "gateup": hidden, "down": d}[product]
    lo, hi = row_share(channels, blocks, b)
    units = 2 if product == "gateup" else 1
    return [range(u * channels + lo, u * channels + hi) for u in range(units)]


def _final_norm(x, w, eps):
    return _rms(x, w, eps)


def fused_decode_step_plain(stack: dict, x, pos, start, cos, sin, k_cache, v_cache, *,
                            n_heads: int, n_kv_heads: int, hd: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of `fused_decode_step`."""
    cd = x.dtype
    p, s0 = int(pos), int(start)
    lyr = stack["wqkv"].shape[0]
    qr, kr = n_heads * hd, n_kv_heads * hd

    def rnd(a):
        return a.to(cd).float()

    def proj(name, layer, a):
        return (a @ rnd(stack[f"w{name}"][layer]).T) * stack[f"s{name}"][layer]

    xs = x.float().reshape(-1)
    cos, sin = cos.reshape(-1).float(), sin.reshape(-1).float()
    qkn = stack.get("qknorm")
    for i in range(lyr):
        qkv = proj("qkv", i, rnd(_rms(xs, stack["ln1"][i], eps)))
        if "bqkv" in stack:
            qkv = qkv + stack["bqkv"][i]
        q = qkv[:qr].reshape(n_heads, hd)
        k = qkv[qr:qr + kr].reshape(n_kv_heads, hd)
        v = qkv[qr + kr:].reshape(n_kv_heads, hd)
        if qkn is not None:
            q, k = _rms(q, qkn[i, 0], eps), _rms(k, qkn[i, 1], eps)
        q = _rope(q, cos, sin) * hd ** -0.5
        k = _rope(k, cos, sin)
        o = _attention(q, k, v, k_cache[i, :, s0:p].float(), v_cache[i, :, s0:p].float(), rnd)
        k_cache[i, :, p] = k.to(k_cache.dtype)
        v_cache[i, :, p] = v.to(v_cache.dtype)
        xs = xs + proj("o", i, rnd(o.reshape(-1)))
        gu = proj("gateup", i, rnd(_rms(xs, stack["ln2"][i], eps)))
        g, u = gu.chunk(2)
        xs = xs + proj("down", i, rnd(g * torch.sigmoid(g) * u))
    return _final_norm(xs, stack["norm"], eps)[None]


# --------------------------------------------------------------- kernel

def workspace_floats(d: int, hidden: int, n_heads: int, n_kv_heads: int, hd: int) -> int:
    """f32 workspace of one step: the residual, raw qkv, the merged
    attention output, the SwiGLU activation, the chunks' partials and the
    arrival counters (checked by the .cu)."""
    return (d + (n_heads + 2 * n_kv_heads) * hd + n_heads * hd + hidden
            + n_heads * MAX_SPLIT * (hd + 2) + 1 + 2 * n_heads)


def launch_plan(device: torch.device, *, int8: bool, d: int, hidden: int, n_heads: int,
                n_kv_heads: int, hd: int, s_max: int) -> dict:
    """The step's launch on `device` for these sizes, without launching:
    blocks, key chunks a head, weight-ring slots, bytes a slot and shared
    memory bytes of a block."""
    out = torch.zeros(5, dtype=torch.int32)
    _PLAN(device, int(int8), d, hidden, n_heads, n_kv_heads, hd, s_max, out)
    return dict(zip(("blocks", "split", "stages", "stage_bytes", "smem"), out.tolist()))


def fused_decode_step(stack: dict, x: torch.Tensor, pos: torch.Tensor, start: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, *, n_heads: int, n_kv_heads: int, hd: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """One token through the whole stack → h (1, D) f32 after the final norm.

    x (1, D) in the activation dtype; pos, start: 0-d int64 tensors (the
    cache's write slot and first valid slot); cos, sin (hd,) f32 at this
    token's RoPE position (`make_cos_sin`); stack: `prepare_stack`; k_cache,
    v_cache (L, KVH, S_max, hd), whose slot `pos` is written IN PLACE.

    On CUDA: x f32 or bf16; weights all int8 (with scales) or all bf16; the
    cache bf16; hd 64 or 128; D, H·hd and hidden at most 8192 (int8: each a
    multiple of 32); all contiguous. A launch that the card or the kernel
    refuses raises."""
    if x.device.type == "cpu":
        return fused_decode_step_plain(stack, x, pos, start, cos, sin, k_cache, v_cache,
                                       n_heads=n_heads, n_kv_heads=n_kv_heads, hd=hd, eps=eps)
    name = "fused_decode_step"
    ws = [stack[f"w{n}"] for n in ("qkv", "o", "gateup", "down")]
    ss = [stack[f"s{n}"] for n in ("qkv", "o", "gateup", "down")]
    opt = [stack.get("bqkv"), stack.get("qknorm")]
    device = _build.require_cuda(name, x, pos, start, cos, sin, k_cache, v_cache, *ws, *ss,
                                 stack["ln1"], stack["ln2"], stack["norm"],
                                 *(t for t in opt if t is not None))
    lyr, s_max = k_cache.shape[0], k_cache.shape[2]
    d = x.shape[-1]
    hidden = ws[2].shape[1] // 2
    qo = (n_heads + 2 * n_kv_heads) * hd
    if hd not in HEAD_DIMS or n_heads % n_kv_heads or d % 16 or hidden % 16:
        raise ValueError(f"{name}: unsupported hd={hd}, heads={n_heads}/{n_kv_heads}, "
                         f"D={d}, hidden={hidden}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    wdt = ws[0].dtype
    if wdt not in (torch.int8, torch.bfloat16):
        raise ValueError(f"{name}: weights must be int8 or bf16, got {wdt}")
    shapes = [(qo, d), (d, n_heads * hd), (2 * hidden, d), (d, hidden)]
    for n, w, s, shape in zip(("qkv", "o", "gateup", "down"), ws, ss, shapes):
        _build.check(f"{name} w{n}", w, wdt, (lyr, *shape))
        _build.check(f"{name} s{n}", s, torch.float32, (lyr, shape[0]))
    for n, t, shape in (("ln1", stack["ln1"], (lyr, d)), ("ln2", stack["ln2"], (lyr, d)),
                        ("norm", stack["norm"], (d,)), ("x", x, (1, d)), ("pos", pos, ()),
                        ("start", start, ()), ("cos", cos, (hd,)), ("sin", sin, (hd,))):
        dt = {"x": x.dtype, "pos": torch.int64, "start": torch.int64}.get(n, torch.float32)
        _build.check(f"{name} {n}", t, dt, shape)
    if opt[0] is not None:
        _build.check(f"{name} bqkv", opt[0], torch.float32, (lyr, qo))
    if opt[1] is not None:
        _build.check(f"{name} qknorm", opt[1], torch.float32, (lyr, 2, hd))
    for n, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check(f"{name} {n}", c, torch.bfloat16, (lyr, n_kv_heads, s_max, hd))
    n_work = workspace_floats(d, hidden, n_heads, n_kv_heads, hd)
    work = torch.empty(n_work, dtype=torch.float32, device=device)
    h = torch.empty((1, d), dtype=torch.float32, device=device)
    _KERNEL(device, x, int(x.dtype == torch.bfloat16), pos, start, cos, sin,
            ws[0], ss[0], opt[0], opt[1], ws[1], ss[1], ws[2], ss[2], ws[3], ss[3],
            stack["ln1"], stack["ln2"], stack["norm"], k_cache, v_cache, h, work, n_work,
            float(eps), int(wdt == torch.int8), lyr, d, hidden, n_heads, n_kv_heads, hd, s_max)
    LAUNCHES["fused_decode_step"] += 1
    return h
