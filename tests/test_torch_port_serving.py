"""PyTorch port, continuous batching (api/serving.py) against the JAX
package's ContinuousBatcher on the CPU.

The f32 cases run at the JAX test's config (tests/test_serving.py: dim
32, 2 layers, vocabulary 48) on the same weights (the JAX init moved by
`convert.params_from_numpy`), both caches bf16 as the generators build
them; the int8 case at the Orpheus tests' Llama (dim 256, hd 64) on the
requantised q4 tree, with the JAX W8A8 matmuls in interpret mode
(`jax_kernels`). Greedy tokens must equal JAX's token for token: the two
stacks agree to ~1e-7 and these prompts leave no step nearer a tie.

ROADMAP C26 and C27 are pinned on both packages: the JAX batcher decodes
past its ring and, once its ring is spent, spins with a request queued;
the port admits a request only where its whole span budget fits and
rewinds the idle position.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_int8 import jax_kernels  # noqa: F401
from tests.test_torch_port_threads import host_threads, worker_mark  # noqa: F401
from tpu_audio.api.serving import ContinuousBatcher as JBatcher
from tpu_audio.api.serving import Request as JRequest
from tpu_audio.models.orpheus.model import CausalLMGenerator as JGenerator
from tpu_audio.nn import transformer as jt
from tpu_audio.ops import quant as jquant
from tpu_audio.ops.sampling import SamplerConfig as JSampler
from tpu_audio_torch.api.serving import ContinuousBatcher, Request
from tpu_audio_torch.convert import params_from_numpy
from tpu_audio_torch.models.orpheus.model import LLAMA_3B, CausalLMGenerator
from tpu_audio_torch.nn import transformer as tt
from tpu_audio_torch.ops.sampling import SamplerConfig

CFG = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=64, vocab_size=48,
           tie_word_embeddings=True)
PROMPTS = [[3, 5, 7], [2, 4, 6, 8, 10], [9, 1], [11, 3, 5, 2], [7, 7, 2, 9, 4, 1], [1, 2, 3]]
EOS = (47,)
GREEDY = dict(temperature=0.0)
PENALTY = dict(temperature=0.0, repetition_penalty=1.4, repetition_window=6)


def generators(max_cache: int, cfg=CFG, tree=None):
    """(JAX generator, port generator) over the same f32 weights."""
    jcfg, tcfg = jt.TransformerConfig(**cfg), tt.TransformerConfig(**cfg)
    jp = tree if tree is not None else jt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float32)
    return (JGenerator(jp, jcfg, max_cache=max_cache),
            CausalLMGenerator(tp, tcfg, max_cache=max_cache))


@pytest.fixture(scope="module")
def gens():
    return generators(512)


def batchers(jg, tg, sampler: dict, batch=2, span=4, bucket=8):
    return (JBatcher(jg, batch=batch, span=span, sampler=JSampler(**sampler), eos_ids=EOS,
                     prompt_bucket=bucket),
            ContinuousBatcher(tg, batch=batch, span=span, sampler=SamplerConfig(**sampler),
                              eos_ids=EOS, prompt_bucket=bucket))


def serve(b, request, prompts, max_new):
    for p in prompts:
        b.submit(request(list(p), max_new=max_new))
    return {tuple(r.prompt_ids): r.tokens for r in b.run_until_idle()}


@pytest.mark.parametrize("sampler", [GREEDY, PENALTY], ids=["greedy", "penalty"])
def test_greedy_rows_match_the_jax_batcher(gens, sampler):
    jg, tg = gens
    jb, tb = batchers(jg, tg, sampler)
    want, got = serve(jb, JRequest, PROMPTS, 20), serve(tb, Request, PROMPTS, 20)
    assert len(got) == len(PROMPTS)
    for p in PROMPTS:
        assert got[tuple(p)] == want[tuple(p)], p
        single = tg.generate(p, sampler=SamplerConfig(**sampler), eos_ids=EOS, max_new=20)
        assert got[tuple(p)] == single, p


def trickle(b, request):
    """Two requests up front, then one more after each span."""
    b.submit(request(list(PROMPTS[0]), max_new=16))
    b.submit(request(list(PROMPTS[1]), max_new=16))
    steps, submitted, spans = 0, 2, []
    while b.step() or submitted < len(PROMPTS):
        steps += 1
        spans.append(b.pos)
        if submitted < len(PROMPTS):
            b.submit(request(list(PROMPTS[submitted]), max_new=16))
            submitted += 1
        assert steps < 200
    return {tuple(r.prompt_ids): r.tokens for r in b.completed}, spans


def test_staggered_arrivals(gens):
    jg, tg = gens
    jb, tb = batchers(jg, tg, GREEDY)
    (want, jpos), (got, tpos) = trickle(jb, JRequest), trickle(tb, Request)
    assert got == want
    assert tpos == jpos  # the same admissions at the same shared positions


def test_max_new_truncation(gens):
    jg, tg = gens
    jb, tb = batchers(jg, tg, GREEDY)
    want, got = serve(jb, JRequest, [[3, 5, 7]], 5), serve(tb, Request, [[3, 5, 7]], 5)
    assert got == want and len(got[(3, 5, 7)]) == 5
    assert got[(3, 5, 7)] == tg.generate([3, 5, 7], sampler=SamplerConfig(**GREEDY),
                                         eos_ids=EOS, max_new=5)


def test_one_token_requests_finish_at_admission(gens):
    _, tg = gens
    tb = batchers(*gens, GREEDY)[1]
    got = serve(tb, Request, PROMPTS[:3], 1)
    assert tb.pos == 8  # no span decoded
    for p in PROMPTS[:3]:
        assert got[tuple(p)] == tg.generate(p, sampler=SamplerConfig(**GREEDY), eos_ids=EOS,
                                            max_new=1)


def test_latency_accounting(gens):
    tb = batchers(*gens, GREEDY)[1]
    tb.submit(Request([3, 5, 7], max_new=6))
    r = tb.run_until_idle()[0]
    assert r.done and r.first_token_at >= r.arrival
    assert r.done_at >= r.first_token_at


def test_int8_tree_matches_the_jax_batcher(jax_kernels):  # noqa: F811
    llm = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64, hidden_dim=512,
               vocab_size=640, rope_theta=500000.0, rope_scaling=dict(LLAMA_3B.rope_scaling),
               norm_eps=1e-5, tie_word_embeddings=True)
    jp = jt.init_params(jax.random.PRNGKey(11), jt.TransformerConfig(**llm))
    rng = np.random.default_rng(1)
    jp["embed"]["weight"] = jax.numpy.asarray(
        rng.standard_normal((llm["vocab_size"], llm["dim"])).astype(np.float32))
    jp = jquant.requantize_tree_int8(jquant.quantize_tree(jp, bits=4))
    jg, tg = generators(256, llm, jp)
    assert "weight_i8" in tg.params["layers"]["attn"]["qkv"]
    sampler = dict(temperature=0.0, repetition_penalty=50.0, repetition_window=20)
    prompts = [[5, 77, 300, 12, 9, 613, 41], [8, 1, 500], [33, 2, 71, 19, 600]]
    jb, tb = batchers(jg, tg, sampler, bucket=16)
    want, got = serve(jb, JRequest, prompts, 12), serve(tb, Request, prompts, 12)
    assert got == want
    assert all(len(t) == 12 for t in got.values())


def test_top_k_1_sampling_equals_greedy(gens):
    jg, tg = gens
    tb = ContinuousBatcher(tg, batch=2, span=4, eos_ids=EOS, prompt_bucket=8, seed=3,
                           sampler=SamplerConfig(temperature=0.8, top_k=1))
    greedy = batchers(jg, tg, GREEDY)[1]
    assert serve(tb, Request, PROMPTS, 12) == serve(greedy, Request, PROMPTS, 12)


def test_c26_the_jax_batcher_decodes_past_its_ring():
    """One request of 60 tokens at a 48-slot ring: the JAX batcher admits it
    (8 + 4 + 1 ≤ 48), then decodes to position 68, its writes clamped, and
    its tokens leave the 512-slot generate's at token 54. The port refuses
    the request at that ring, and at a ring that holds its budget (8 + 60 +
    1 ≤ 72) completes it with the roomy generate's tokens."""
    jg48, tg48 = generators(48)
    jg, tg = generators(512)
    want = tg.generate([3, 5, 7], sampler=SamplerConfig(**PENALTY), eos_ids=EOS, max_new=60)
    assert want == jg.generate([3, 5, 7], sampler=JSampler(**PENALTY), eos_ids=EOS, max_new=60)
    jb, tb = batchers(jg48, tg48, PENALTY)
    jb.submit(JRequest([3, 5, 7], max_new=60))
    got = jb.run_until_idle()[0].tokens
    assert jb.pos == 68 > jg48.max_cache
    assert len(got) == 60 and got[:54] == want[:54] and got[54] != want[54]
    with pytest.raises(ValueError, match="max_cache"):
        tb.submit(Request([3, 5, 7], max_new=60))
    tb72 = batchers(*generators(72), PENALTY)[1]
    tb72.submit(Request([3, 5, 7], max_new=60))
    assert tb72.run_until_idle()[0].tokens == want and tb72.pos <= 72


def test_c26_a_request_that_does_not_fit_waits():
    """Rows in flight: a request whose span budget would pass the ring
    waits for them to drain; the position never passes the ring and every
    request completes with the roomy ring's tokens."""
    _, tg = generators(48)
    _, roomy = generators(512)
    tb = ContinuousBatcher(tg, batch=2, span=4, sampler=SamplerConfig(**GREEDY), eos_ids=EOS,
                           prompt_bucket=8)
    reqs = [Request([3, 5, 7], max_new=20), Request([9, 1], max_new=24),
            Request([2, 4, 6, 8, 10], max_new=30)]
    for r in reqs:
        tb.submit(r)
    positions = []
    while tb.step():
        positions.append(tb.pos)
        assert tb.pos <= 48
    assert max(positions) <= 48 and any(b < a for a, b in zip(positions, positions[1:]))
    for r in reqs:
        assert r.done and r.tokens == roomy.generate(
            r.prompt_ids, sampler=SamplerConfig(**GREEDY), eos_ids=EOS, max_new=r.max_new)


def test_c27_an_idle_batcher_rewinds_a_spent_ring():
    """The JAX batcher after the 60-token run of C26: a new request stays
    queued and step() returns True 1,000 times. On a ring both packages
    stay inside ([3, 5, 7] for 37 tokens leaves P at 44 of 48), JAX stalls
    the same way, and the port rewinds and serves [2, 4, 6]."""
    jg48, tg48 = generators(48)
    _, roomy = generators(512)
    jb = batchers(jg48, tg48, PENALTY)[0]
    jb.submit(JRequest([3, 5, 7], max_new=60))
    jb.run_until_idle()
    jb.submit(JRequest([2, 4, 6], max_new=4))
    assert all(jb.step() for _ in range(1000)) and len(jb.queue) == 1

    jb, tb = batchers(jg48, tg48, PENALTY)
    for b, request in ((jb, JRequest), (tb, Request)):
        b.submit(request([3, 5, 7], max_new=37))
        b.run_until_idle()
        assert b.pos == 44
        b.submit(request([2, 4, 6], max_new=4))
    assert all(jb.step() for _ in range(1000)) and len(jb.queue) == 1
    assert not tb.step() and not tb.queue  # admitted at P = 8 and served in one span
    want = roomy.generate([2, 4, 6], sampler=SamplerConfig(**PENALTY), eos_ids=EOS, max_new=4)
    assert tb.completed[-1].tokens == want
    assert tb.completed[0].tokens == roomy.generate(
        [3, 5, 7], sampler=SamplerConfig(**PENALTY), eos_ids=EOS, max_new=37)


def test_ring_exhaustion_serves_every_request():
    """tests/test_serving.py's 48-slot ring with six 8-token requests at two
    rows: both packages serve all six with the same tokens, each equal to
    its generate, and the port's position never passes the ring."""
    jg48, tg48 = generators(48)
    jb, tb = batchers(jg48, tg48, GREEDY)
    want = serve(jb, JRequest, PROMPTS, 8)
    for p in PROMPTS:
        tb.submit(Request(list(p), max_new=8))
    while tb.step():
        assert tb.pos <= 48
    got = {tuple(r.prompt_ids): r.tokens for r in tb.completed}
    assert got == want and len(got) == len(PROMPTS)
    for p in PROMPTS:
        assert got[tuple(p)] == tg48.generate(p, sampler=SamplerConfig(**GREEDY), eos_ids=EOS,
                                              max_new=8)


def test_a_generator_without_a_ring_is_refused():
    tp = tt.init_params(0, tt.TransformerConfig(**CFG), device="cpu")
    gen = CausalLMGenerator(tp, tt.TransformerConfig(**CFG), max_cache=None)
    with pytest.raises(ValueError, match="max_cache"):
        ContinuousBatcher(gen, batch=2, span=4, sampler=SamplerConfig(**GREEDY), eos_ids=EOS)
