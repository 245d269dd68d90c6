"""PyTorch port, bidirectional encoder attention (`ops/kernels/
encoder_attention.py`) against the JAX package on the CPU: the plain
versions of `encoder_attention` ((B, T, H, D) and head-major) and
`encoder_attention_packed` against the Pallas kernels in interpret mode,
the `supported` predicate against the JAX gate's shape rule, and the
routing of `nn.attention.attend`.

Shapes: 4 heads of 64 at T = 600 (which the JAX wrappers pad to 640) and
T = 1100 (1152), with keys past t_valid holding large values and a scale
other than 1 (the two entries apply it at different places). f32 outputs
are held at max|Δ|/max|ref| ≤ 1e-5 (measured ≤ 9.5e-7): both sides compute
the same terms, summed in another order. The bf16 cases are held at 2^-7
of max|ref| (measured 6.9e-4 and 1.4e-3): the f32 sums differ in their last
bits, which can flip the bf16 rounding of an exponential (2^-8 of it) and
of an output (2^-8 of its magnitude).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.nn import attention as jattention
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.pallas import encoder_attention as jea
from tpu_audio_torch.models.funasr import model as tfunasr
from tpu_audio_torch.models.whisper import model as tmodel
from tpu_audio_torch.models.whisper.config import WhisperConfig
from tpu_audio_torch.nn import attention as tattention
from tpu_audio_torch.nn import transformer
from tpu_audio_torch.ops.kernels import encoder_attention as ea
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, HD = 4, 64


def without_tpu_check(fn):
    """A JAX kernel gate with its backend check passed: the shape rule only."""
    def gate(*args, **kwargs):
        with mock.patch.object(jax, "default_backend", lambda: "tpu"):
            return fn(*args, **kwargs)
    return gate


@pytest.fixture
def jax_attention(monkeypatch):
    """The JAX package's encoder-attention kernels in interpret mode, their
    gate's shape rule on and the pair-packed probe passed; a fallback to
    the plain path raises, so a parity test cannot compare plain with
    plain. Returns the kernels' call counts (calls while tracing: a scan
    over layers traces its body once)."""
    calls = {"encoder_attention": 0, "encoder_attention_packed": 0}
    for name in calls:
        def kernel(*args, _fn=getattr(jea, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, interpret=True, **kwargs)
        monkeypatch.setattr(jea, name, kernel)
    monkeypatch.setattr(jea, "supported", without_tpu_check(jea.supported))
    monkeypatch.setattr(jea, "packed_probe", lambda hd, dtype: True)

    def no_fallback(exc):
        raise exc
    monkeypatch.setattr(jquant, "_warn_kernel_fallback", no_fallback)
    return calls


def spy(monkeypatch):
    """Count the port's calls of both entries (on CPU tensors they run the
    plain versions, which LAUNCHES does not count)."""
    calls = {name: 0 for name in ea.LAUNCHES}
    for name in calls:
        def entry(*args, _fn=getattr(ea, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(ea, name, entry)
    return calls


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def inputs(t: int, t_valid: int | None, layout: str, dtype=np.float32, seed: int = 0):
    """q, k, v of 2 × 4 heads in `layout` ("bthd", "pre_bh", "packed"); keys
    at or past t_valid hold 50 and their values -100, so a kernel that read
    them would be far off."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, H, t, HD)).astype(np.float32) for _ in range(3))
    if t_valid is not None:
        k[:, :, t_valid:] = 50.0
        v[:, :, t_valid:] = -100.0
    if layout == "bthd":
        out = [a.transpose(0, 2, 1, 3) for a in (q, k, v)]
    elif layout == "pre_bh":
        out = [a.reshape(2 * H, t, HD) for a in (q, k, v)]
    else:  # head pairs: head j of pair g at channels [j·hd, (j+1)·hd)
        out = [a.reshape(2, H // 2, 2, t, HD).transpose(0, 1, 3, 2, 4).reshape(H, t, 2 * HD)
               for a in (q, k, v)]
    return [np.ascontiguousarray(a).astype(dtype) for a in out]


def run_both(layout, q, k, v, t_valid, scale, jdtype=jnp.float32):
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jdtype) for a in (q, k, v))
    if layout == "packed":
        got = ea.encoder_attention_packed(tq, tk, tv, t_valid=t_valid, scale=scale)
        ref = jea.encoder_attention_packed(jq, jk, jv, t_valid=t_valid, scale=scale,
                                           interpret=True)
    else:
        pre_bh = layout == "pre_bh"
        got = ea.encoder_attention(tq, tk, tv, t_valid=t_valid, scale=scale, pre_bh=pre_bh)
        ref = jea.encoder_attention(jq, jk, jv, t_valid=t_valid, scale=scale, pre_bh=pre_bh,
                                    interpret=True)
    assert got.dtype == tq.dtype
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32))


CASES = [(600, None, None), (1100, 1000, 0.3)]


@pytest.mark.parametrize("layout", ["bthd", "pre_bh", "packed"])
@pytest.mark.parametrize("t,t_valid,scale", CASES)
def test_plain_matches_the_pallas_kernels(layout, t, t_valid, scale):
    q, k, v = inputs(t, t_valid, layout)
    got, ref = run_both(layout, q, k, v, t_valid, scale)
    assert rel_err(got, ref) <= 1e-5
    if t_valid is not None:  # the planted keys would dominate if read
        unmasked = ea.encoder_attention_packed_plain if layout == "packed" else functools.partial(
            ea.encoder_attention_plain, pre_bh=layout == "pre_bh")
        wrong = unmasked(*(torch.from_numpy(a) for a in (q, k, v)), scale=scale).numpy()
        assert rel_err(wrong, ref) > 0.5


@pytest.mark.parametrize("layout", ["bthd", "packed"])
def test_bf16_plain_matches_the_pallas_kernels(layout):
    """bf16 inputs, keys past t_valid planted, scale 0.3: the (B, T, H, D)
    entry scales the f32 scores, the packed entry rounds q·0.3 to bf16
    first, each plain version as its own JAX entry."""
    q, k, v = inputs(1100, 1000, layout, seed=2)
    got, ref = run_both(layout, q, k, v, 1000, 0.3, jnp.bfloat16)
    assert rel_err(got, ref) <= 2 ** -7


def test_supported_is_the_jax_shape_rule():
    jax_rule = without_tpu_check(jea.supported)
    shapes = [(1, t, h, d) for t in (500, 511, 512, 1500, 4096, 4097)
              for h, d in ((20, 64), (2, 128), (1, 256), (1, 257))]
    n_true = 0
    for shape in shapes:
        q = np.empty(shape, np.float32)
        for k, mask in ((q, None), (q, np.zeros((1, 1, 1, shape[1]), np.float32)),
                        (np.empty((1, 1, *shape[2:]), np.float32), None)):
            assert ea.supported(q, k, mask) == jax_rule(q, k, mask), (shape, k.shape, mask)
            n_true += ea.supported(q, k, mask)
    q3 = np.empty((20, 1500, 64), np.float32)
    assert ea.supported(q3, q3, None) is jax_rule(q3, q3, None) is False
    assert n_true == 6  # T 512..4096 at d 64, 512..1500 at d 128, 512 at d 256


# ---------------------------------------------------------------- routing

def test_attend_routes_where_the_jax_attend_does(jax_attention, monkeypatch):
    """The port's `attend` calls `encoder_attention` exactly for the calls
    for which the JAX `attend` calls its kernel, and both agree."""
    calls = spy(monkeypatch)
    rng = np.random.default_rng(3)

    def qkv(tq, tk, hkv=H):
        return (rng.standard_normal((1, tq, H, HD)).astype(np.float32),
                rng.standard_normal((1, tk, hkv, HD)).astype(np.float32),
                rng.standard_normal((1, tk, hkv, HD)).astype(np.float32))

    mask = np.zeros((1, 1, 600, 600), np.float32)
    cases = [("self, T 600", qkv(600, 600), None, True),
             ("self, T 300", qkv(300, 300), None, False),
             ("masked", qkv(600, 600), mask, False),
             ("cross, Tq 4", qkv(4, 600), None, False),
             ("GQA", qkv(600, 600, hkv=2), None, False)]
    for label, (q, k, v), m, routed in cases:
        before_t, before_j = calls["encoder_attention"], jax_attention["encoder_attention"]
        got = tattention.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                                None if m is None else torch.from_numpy(m))
        ref = jattention.attend(*(jnp.asarray(a) for a in (q, k, v)),
                                None if m is None else jnp.asarray(m), q_scaled=True)
        assert rel_err(got.numpy(), ref) <= 1e-5, label
        assert calls["encoder_attention"] - before_t == int(routed), label
        assert jax_attention["encoder_attention"] - before_j == int(routed), label
    # the routed call takes its scale on the f32 scores, as the JAX kernel does
    q, k, v = qkv(600, 600)
    got = tattention.attend(*(torch.from_numpy(a) for a in (q, k, v)), scale=0.125)
    ref = jattention.attend(*(jnp.asarray(a) for a in (q, k, v)), scale=0.125)
    assert rel_err(got.numpy(), ref) <= 1e-5


def test_no_current_caller_changes_route(monkeypatch):
    """Fun-ASR's SANM encoder at T ≥ 512 and the Whisper and LLM decoders
    all pass a mask or attend across lengths: none reaches the kernel. The
    per-op Whisper encoder does, once per block."""
    calls = spy(monkeypatch)
    enc = tfunasr.SenseVoiceConfig(input_dim=560, encoder_dim=64, num_heads=1, ffn_dim=64,
                                   num_encoders0=1, num_encoders=1, num_tp_encoders=1,
                                   kernel_size=5)
    cfg = tfunasr.FunASRConfig(encoder=enc, adaptor=tfunasr.AdaptorConfig(
        encoder_dim=64, downsample_rate=2, ffn_dim=64, llm_dim=128, n_layer=1,
        attention_heads=2), llm=transformer.TransformerConfig(
        dim=128, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=256, vocab_size=300))
    params = tfunasr.init_params(0, cfg, torch.float32, "cpu")
    feats = torch.randn(1, 520, 560)
    audio = tfunasr.encode(params["encoder"], enc, feats, torch.tensor([520]))
    tfunasr.adapt(params["adaptor"], cfg.adaptor, audio, torch.tensor([520]))
    cache = transformer.make_cache(cfg.llm, 1, 32, torch.float32, device="cpu")
    transformer.forward(params["llm"], cfg.llm, torch.tensor([[1, 2, 3]]), cache)

    wcfg = WhisperConfig(n_mels=80, n_audio_ctx=600, n_audio_state=256, n_audio_head=4,
                         n_audio_layer=2, n_vocab=600, n_text_ctx=16, n_text_state=256,
                         n_text_head=4, n_text_layer=2)
    model = tmodel.Whisper(wcfg, tmodel.init_params(0, wcfg, device="cpu"))
    feats = torch.randn(1, 600, 256)
    state = model.init_state(feats, kv_int8=False)
    model.decode_step(torch.tensor([[1, 2, 3]]), state)
    model.decode_step(torch.tensor([[4]]), state)
    model.forward_cross_qk(torch.tensor([[1, 2, 3]]), feats)
    assert calls == {"encoder_attention": 0, "encoder_attention_packed": 0}
    monkeypatch.setattr(tmodel, "FUSED_ENC", False)
    model.encode(torch.randn(1, 1200, 80))
    assert calls == {"encoder_attention": 0, "encoder_attention_packed": 2}


def test_wrappers_launch_nothing_on_cpu_and_refuse_other_devices():
    q, k, v = (torch.from_numpy(a) for a in inputs(600, None, "bthd"))
    p = [torch.from_numpy(a) for a in inputs(600, None, "packed")]
    before = dict(ea.LAUNCHES)
    ea.encoder_attention(q, k, v)
    ea.encoder_attention_packed(*p)
    assert ea.LAUNCHES == before
    for call in (lambda: ea.encoder_attention(q.to("meta"), k, v),
                 lambda: ea.encoder_attention(q.to("meta"), k.to("meta"), v.to("meta")),
                 lambda: ea.encoder_attention_packed(p[0].to("meta"), *p[1:])):
        with pytest.raises(ValueError, match="CUDA"):
            call()
