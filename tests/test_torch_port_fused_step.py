"""PyTorch port, the whole-stack Llama / Qwen decode step's algebra on the
CPU: the kernel splits query head j's keys into chunks (`chunk_bounds`)
and lets the chunk that arrives last merge them with the current token's
own term (`fused_step.attention_chunks` is that partition and merge in
PyTorch), and gives each block a contiguous share of every product's
output channels, the gate and up rows of the same channels together
(`row_share`, `block_rows`).

`attention_chunks` against the unsplit `fused_step._attention` at 1, 2, 13
and 32 chunks, with empty chunks among them (9 keys) and none at all (0),
f32 and bf16 rounding, GQA 8 heads over 2 (hd 64) and Qwen3-0.6B's 16 over
8 (hd 128): f32 within 1e-5 of max|ref| (one pass a chunk: the same terms
summed in another order); bf16 within 1e-2 (each probability rounded
against the head's max and sum, which the split sums in another order, so a
probability may round one bf16 step apart). The faults chip_smoke plants
(the fresh term dropped, a chunk merged twice, KV head j % KVH) move the
result past 5e-2. The whole plain step with the chunked attention against
the plain step (1e-5). The block-to-row map at Qwen3-0.6B's and
Llama-3.2-3B's widths and the grid sizes the launch can pick (one block an
SM: 132 on an H100 SXM, 114 on a PCIe card). `tools/fused_step_split.py`'s
cuts apply to the repository's sources and to those of the previous
design (one warp a row, two attention passes; its `fused_step.cu` and
`decode_step.cuh` kept under `tests/data/`).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_audio_torch.models.funasr.model import QWEN3_06B
from tpu_audio_torch.models.orpheus.model import LLAMA_3B
from tpu_audio_torch.ops.kernels import fused_step as fs
from tpu_audio_torch.tools import fused_step_split
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

PARENT = Path(__file__).resolve().parent / "data" / "fused_step_parent"
GRIDS = (114, 132)


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def bf16_round(a):
    return a.to(torch.bfloat16).float()


def attention_inputs(rng, n: int, h: int, kvh: int, hd: int):
    """q (H, hd), k, v (KVH, hd) of the current token and a history k_hist,
    v_hist (KVH, n, hd), f32, with scores of std ~2."""
    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    s = 2.0 / hd ** 0.5
    return f(h, hd, scale=s ** 0.5), f(kvh, hd, scale=s ** 0.5), f(kvh, hd), \
        f(kvh, n, hd, scale=s ** 0.5), f(kvh, n, hd)


HEADS = {"8/2 hd 64": (8, 2, 64), "16/8 hd 128": (16, 8, 128)}


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("rb", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [0, 9, 260])
@pytest.mark.parametrize("split", [1, 2, 13, 32])
def test_attention_chunks_match_unsplit(rng, split, n, rb, heads):
    q, k, v, kh, vh = attention_inputs(rng, n, *HEADS[heads])
    rnd = bf16_round if rb else (lambda a: a)
    if rb:
        vh = bf16_round(vh)
    got = fs.attention_chunks(q, k, v, kh, vh, rnd, split=split, rb=rb)
    ref = fs._attention(q, k, v, kh, vh, rnd)
    assert got.shape == ref.shape == (q.shape[0], q.shape[1])
    assert rel_err(got, ref) <= (1e-2 if rb else 1e-5)


@pytest.mark.parametrize("fault", ["fresh term dropped", "chunk merged twice",
                                   "KV head j % KVH"])
@pytest.mark.parametrize("rb", [False, True], ids=["f32", "bf16"])
def test_attention_chunk_faults_are_visible(rng, rb, fault):
    """At 8 chunks (the kernel's Qwen3 split on an H100) of 260 keys; a
    chunk merged twice is the last one holding keys. The fresh term is one
    of 261 there, so it is dropped at one key of history, as chip_smoke
    plants it at pos = start + 1."""
    n = 1 if fault == "fresh term dropped" else 260
    q, k, v, kh, vh = attention_inputs(rng, n, 16, 8, 128)
    rnd = bf16_round if rb else (lambda a: a)
    split = 8
    last = len([b for a, b in fs.chunk_bounds(n, split) if b > a]) - 1
    kw = {"fresh term dropped": {"drop_fresh": True},
          "chunk merged twice": {"twice": last},
          "KV head j % KVH": {"kv_head": lambda j: j % 8}}[fault]
    ref = fs._attention(q, k, v, kh, vh, rnd)
    got = fs.attention_chunks(q, k, v, kh, vh, rnd, split=split, rb=rb, **kw)
    assert rel_err(got, ref) > 5e-2


def test_chunk_bounds_partition_the_keys():
    """The partition covers [0, n) in order, with empty chunks at the end."""
    for n, split in ((0, 8), (1, 2), (9, 13), (260, 8), (128, 5), (1024, 32)):
        bounds = fs.chunk_bounds(n, split)
        assert len(bounds) == split and bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a <= b and b == c for (a, b), (c, _) in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("split", [5, 8])
def test_plain_step_with_chunked_attention_matches(rng, split):
    """The plain whole-stack step (2 layers, Qwen3-style q/k-norm, GQA 4
    over 2, hd 64, f32) with `_attention` replaced by the chunked merge
    gives the same h and cache slot as with the unsplit attention (1e-5)."""
    lyr, d, h, kvh, hd, hidden, s_max, p, s0 = 2, 256, 4, 2, 64, 512, 64, 40, 3
    qo = (h + 2 * kvh) * hd

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    stack = {"wqkv": f(lyr, qo, d, scale=d ** -0.5),
             "wo": f(lyr, d, h * hd, scale=(h * hd) ** -0.5),
             "wgateup": f(lyr, 2 * hidden, d, scale=d ** -0.5),
             "wdown": f(lyr, d, hidden, scale=hidden ** -0.5),
             "sqkv": torch.ones(lyr, qo), "so": torch.ones(lyr, d),
             "sgateup": torch.ones(lyr, 2 * hidden), "sdown": torch.ones(lyr, d),
             "ln1": 1 + 0.3 * f(lyr, d), "ln2": 1 + 0.3 * f(lyr, d), "norm": 1 + 0.3 * f(d),
             "qknorm": 1 + 0.3 * f(lyr, 2, hd)}
    kc, vc = f(lyr, kvh, s_max, hd, scale=2.0), f(lyr, kvh, s_max, hd)
    x = f(1, d, scale=0.5)
    pos, start = torch.tensor(p), torch.tensor(s0)
    cos, sin = fs.make_cos_sin(pos, QWEN3_06B.inv_freq()[: hd // 2])
    kw = dict(n_heads=h, n_kv_heads=kvh, hd=hd, eps=1e-6)
    kc_ref, vc_ref = kc.clone(), vc.clone()
    ref = fs.fused_decode_step_plain(stack, x, pos, start, cos, sin, kc_ref, vc_ref, **kw)
    unsplit = fs._attention
    try:
        fs._attention = lambda q, k, v, kh, vh, rnd: fs.attention_chunks(
            q, k, v, kh, vh, rnd, split=split, rb=False)
        got = fs.fused_decode_step_plain(stack, x, pos, start, cos, sin, kc, vc, **kw)
    finally:
        fs._attention = unsplit
    assert rel_err(got, ref) <= 1e-5
    assert rel_err(kc[:, :, p], kc_ref[:, :, p]) <= 1e-5
    assert rel_err(vc[:, :, p], vc_ref[:, :, p]) <= 1e-5


@pytest.mark.parametrize("blocks", GRIDS)
@pytest.mark.parametrize("cfg", [QWEN3_06B, LLAMA_3B], ids=["qwen3-0.6b", "llama-3.2-3b"])
def test_block_rows_cover_each_product_once(cfg, blocks):
    """Every row of each product's stacked weight is streamed by exactly one
    block; each block's rows of a unit are one contiguous range; of gate/up
    a block holds the gate and the up rows of the same channels; no block
    holds more channels than the epilogue has threads (256)."""
    d, hidden, qo = cfg.dim, cfg.hidden_dim, (cfg.n_heads + 2 * cfg.kv_heads) * cfg.hd
    rows = {"qkv": qo, "o": d, "gateup": 2 * hidden, "down": d}
    for product, total in rows.items():
        seen = torch.zeros(total, dtype=torch.int64)
        for b in range(blocks):
            ranges = fs.block_rows(product, d, hidden, qo, blocks, b)
            assert len(ranges) == (2 if product == "gateup" else 1)
            for r in ranges:
                seen[r.start:r.stop] += 1
            if product == "gateup":
                gate, up = ranges
                assert (up.start - hidden, up.stop - hidden) == (gate.start, gate.stop)
            assert len(ranges[0]) <= 256
        assert bool((seen == 1).all()), product


def test_row_shares_are_contiguous_and_ordered():
    """Block b's share starts where block b - 1's ends, and the shares
    differ in size by at most one channel."""
    for channels in (1024, 3072, 4096, 5120, 8192):
        for blocks in GRIDS:
            shares = [fs.row_share(channels, blocks, b) for b in range(blocks)]
            assert shares[0][0] == 0 and shares[-1][1] == channels
            assert all(hi == lo for (_, hi), (lo, _) in zip(shares, shares[1:]))
            sizes = {hi - lo for lo, hi in shares}
            assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("csrc", [fused_step_split.CSRC, PARENT], ids=["repository", "parent"])
def test_fused_step_split_cuts_apply_to_the_sources(csrc):
    """tools/fused_step_split.py recognises both versions' sources, and
    each of its cuts changes them (its marks all match, or it would
    refuse)."""
    sources = fused_step_split.read_sources(csrc)
    name = fused_step_split.layout(sources)
    versions = fused_step_split.variants(sources)
    assert list(versions) == ["kernel", *fused_step_split.LAYOUTS[name], "all cut"]
    assert versions["kernel"] == sources
    for variant, files in versions.items():
        changed = {f for f in files if files[f] != sources[f]}
        assert bool(changed) == (variant != "kernel"), variant
        assert changed <= {fused_step_split.STEP, "decode_step.cuh"}
    assert len(set(fused_step_split.LAYOUTS) - {name}) == 1
