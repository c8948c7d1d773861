"""Serving the two registry ids that only ``chip_smoke.py``'s
``serve_qwen15_llava``, ``llava_image`` and ``parity_qwen15_llava`` phases
run on the card, on the CPU at SMOKE size against the JAX package:
llava-next-mistral-7b, whose prefill takes image embeddings for its first
``num_patches`` positions (SMOKE: 4), and qwen1.5-4b, the only served
config with ``qkv_bias``.

Parameters, tokens and image embeddings are numpy draws from a seed handed
to both packages (the twin of ``tests/test_torch_smoke_archs.py``).  Bars:
float32 logits to 1e-4 of the reference's, every greedy token equal; the
serving layer's static decode (``StaticDecode``) and ``DecodeGraphs``
against the model's own loop bit for bit (on the CPU both run eagerly).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.serving.graphs import DecodeGraphs, StaticDecode
from test_torch_deepseek_training import _chip_smoke
from test_torch_smoke_archs import Twin, _npy

ARCHS_SERVED = ["llava-next-mistral-7b", "qwen1.5-4b"]
B, P, STEPS = 2, 8, 4          # Twin's batch; a prompt longer than 4 patches
MAX_LEN = P + STEPS + 1


@pytest.fixture(scope="module")
def twins():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = Twin(arch, "float32")
        return made[arch]
    yield get
    made.clear()


def _extra(t):
    return None if t.extra is None else torch.from_numpy(t.extra)


def _jax_steps(t):
    """The JAX model's prefill logits over the first P tokens (with the
    image embeddings) and those of STEPS decode steps fed ``tokens[:,
    P:]``."""
    m, toks = t.jmodel, jnp.asarray(t.tokens)
    extra = None if t.extra is None else jnp.asarray(t.extra)
    cache = m.init_cache(B, MAX_LEN)
    out, cache = m.prefill(t.jparams, toks[:, :P], cache, extra)
    logits = [out]
    for i in range(STEPS):
        out, cache = m.decode_step(t.jparams, toks[:, P + i: P + i + 1],
                                   cache, jnp.int32(P + i))
        logits.append(out)
    return logits


@torch.inference_mode()
def _torch_steps(t):
    toks = torch.from_numpy(t.tokens)
    cache = t.model.init_cache(B, MAX_LEN)
    out, cache = t.model.prefill(t.params, toks[:, :P], cache, _extra(t))
    logits = [out]
    for i in range(STEPS):
        out, _ = t.model.decode_step(t.params, toks[:, P + i: P + i + 1],
                                     cache, P + i)
        logits.append(out)
    return logits


@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_prefill_and_teacher_forced_decode_match_jax(arch, twins):
    """The prefill (llava's with its image embeddings in front) and 4
    teacher-forced decode steps: float32 logits within 1e-4 of the JAX
    DecoderLM's at every step, every greedy token equal."""
    t = twins(arch)
    assert (t.extra is not None) == (arch == "llava-next-mistral-7b")
    if t.extra is not None:
        assert t.extra.shape == (B, t.cfg.num_patches, t.cfg.d_model) \
            and t.cfg.num_patches < P
    for got, want in zip(_torch_steps(t), _jax_steps(t)):
        got, want = _npy(got), _npy(want)
        assert got.shape == want.shape == (B, 1, t.cfg.vocab_size)
        assert float(np.abs(got - want).max()) < 1e-4
        assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_image_embeddings_change_the_prefill(twins):
    """The embeddings replace the prompt's first positions: other
    embeddings, other logits; the same tokens without them, others again
    (the model reads the patches, not the tokens under them)."""
    t = twins("llava-next-mistral-7b")
    toks = torch.from_numpy(t.tokens[:, :P])
    extra = _extra(t)

    @torch.inference_mode()
    def logits(embeds):
        cache = t.model.init_cache(B, MAX_LEN)
        return t.model.prefill(t.params, toks, cache, embeds)[0]

    base = logits(extra)
    assert not torch.equal(base, logits(None))
    assert not torch.equal(base, logits(extra.flip(0)))
    other = toks.clone()
    other[:, : t.cfg.num_patches] = (other[:, : t.cfg.num_patches] + 1) \
        % t.cfg.vocab_size
    with torch.inference_mode():
        swapped = t.model.prefill(t.params, other,
                                  t.model.init_cache(B, MAX_LEN), extra)[0]
    assert torch.equal(base, swapped)


@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_static_decode_and_graphs_equal_the_models_loop(arch, twins):
    """``StaticDecode``'s eager steps at the device position and
    ``DecodeGraphs.generate`` (eager on the CPU), both with llava's image
    embeddings, against the model's own greedy loop at int positions: the
    same logits and tokens bit for bit; a second generate of the same key
    reuses its static buffers and gives the same tokens."""
    t = twins(arch)
    toks = torch.from_numpy(t.tokens[:, :P])
    extra = _extra(t)
    with torch.inference_mode():
        cache = t.model.init_cache(B, MAX_LEN)
        logits, cache = t.model.prefill(t.params, toks, cache, extra)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        want_tokens, want_logits = [tok], []
        for i in range(STEPS):
            logits, cache = t.model.decode_step(t.params, tok, cache, P + i)
            want_logits.append(logits)
            tok = torch.argmax(logits, dim=-1)
            want_tokens.append(tok)
        want = torch.cat(want_tokens, dim=1)

        slot = StaticDecode(t.model, t.params, B, MAX_LEN)
        slot.prefill(toks, extra)
        for i in range(STEPS):
            assert torch.equal(slot.step(), want_logits[i]), i
        assert torch.equal(slot.tokens[:, P: P + STEPS + 1], want)

        graphs = DecodeGraphs(t.model, t.params)
        for _ in range(2):
            tokens, _ = graphs.generate(toks, STEPS + 1, MAX_LEN, extra)
            assert torch.equal(tokens, want)
        assert list(graphs.slots) == [(B, MAX_LEN)]
        assert (graphs.captures, graphs.replays, graphs.eager_steps) == \
            (0, 0, 2 * STEPS)


def test_qkv_bias_reaches_the_projections(twins):
    """qwen1.5's q, k and v biases are in the tree and move the logits: the
    model with them zeroed gives other logits."""
    t = twins("qwen1.5-4b")
    attn = t.params["blocks"]["attn"]
    assert t.cfg.qkv_bias and {"bq", "bk", "bv"} <= set(attn)
    zeroed = dict(t.params, blocks=dict(t.params["blocks"], attn=dict(
        attn, **{k: torch.zeros_like(attn[k]) for k in ("bq", "bk", "bv")})))
    toks = torch.from_numpy(t.tokens[:, :P])
    with torch.inference_mode():
        a = t.model.prefill(t.params, toks, t.model.init_cache(B, MAX_LEN))[0]
        b = t.model.prefill(zeroed, toks, t.model.init_cache(B, MAX_LEN))[0]
    assert not torch.equal(a, b)


# --- chip_smoke's phases for the two ids -------------------------------------

@pytest.mark.parametrize("arch,k1,k2", [
    ("llava-next-mistral-7b", 32, 32 * 31), ("qwen1.5-4b", 40, 40 * 31),
    ("whisper-small", 36, 24 * 31)])
def test_generate_launches(arch, k1, k2):
    """``generate_launches``, the counts ``llava_image`` and ``whisper``
    hold a generate call of 32 tokens to: K1 once per attention call at
    the prefill (whisper: 12 encoder, 12 decoder self, 12 cross), K2 once
    per layer (whisper: twice per decoder layer) at each of the 31 decode
    steps, nothing else."""
    cs = _chip_smoke()
    exp = cs.generate_launches(ARCHS[arch])
    assert {k: v for k, v in exp.items() if v} == {"flash_attention": k1,
                                                   "decode_attention": k2}
    assert cs.GEN_LEN == 32


@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_attention_at_input_width_rescales_the_projections(arch):
    """``attention_at_input_width``, the init of the parity phases' whole-
    model gates: every ``wq``, ``wk``, ``wv`` [layers, d, heads, hd] from
    1 / sqrt(heads) to 1 / sqrt(d), everything else (qwen1.5's biases, the
    output projection) untouched."""
    from repro_torch.models.families import build_model
    cs = _chip_smoke()
    cfg = dataclasses.replace(ARCHS[arch], num_layers=1, vocab_size=64,
                              d_ff=64)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in params["blocks"]["attn"].items()}
    cs.attention_at_input_width(params)
    attn = params["blocks"]["attn"]
    for k, v in before.items():
        if k in ("wq", "wk", "wv"):
            scale = (v.shape[-2] / v.shape[-3]) ** 0.5
            assert torch.allclose(attn[k], v * scale)
            assert scale == pytest.approx(
                ((cfg.num_heads if k == "wq" else cfg.num_kv_heads)
                 / cfg.d_model) ** 0.5)
        else:
            assert torch.equal(attn[k], v)
