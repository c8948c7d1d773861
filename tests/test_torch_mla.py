"""deepseek-v2's multi-head latent attention (MLA) in the port against the
JAX package, on SMOKE deepseek (3 layers: a dense first layer and two MoE
layers; 4 heads, query/key head dim 16 + 8, value head dim 16, latent rank
32, query rank 24), from converted parameters: K1's plain version with a
value head dim unlike its query dim, the parameter tree, the block at
prefill and at absorbed decode steps, the whole ``DecoderLM``, its cache,
decode steps at a device position, and a served workflow.  Inputs come
from numpy with a seed, as in ``tests/test_torch_models.py``, whose
helpers this file shares.

Tolerances are those of the other model tests: 1e-5 on a block and 1e-4
on the logits in float32, the softmax bars 0.03 (prefill) / 0.05 (decode)
in bfloat16, and K1's 2e-5 / 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.configs.archs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models.families import build_model
from test_torch_models import (B, S, max_err, pair, softmax_err,  # noqa: F401
                               to_numpy_tree, tree_leaves)
from test_torch_serving import _float32_bundles, _same_tokens_at_prompt_7

DEEPSEEK = "deepseek-v2-236b"
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair_arrays(rng, shape, dtype):
    x = rng.standard_normal(shape, dtype=np.float32)
    return (jnp.asarray(x).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


# ---------------------------------------------------------------------------
# K1 with a value head dim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,sq,sk,h,d,dv", [
    (2, 37, 37, 4, 24, 16),       # SMOKE deepseek's dims, a ragged length
    (2, 17, 40, 4, 24, 16),       # Sq != Sk
    (1, 100, 100, 2, 192, 128),   # deepseek-v2's published dims
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_value_dim_vs_xla_twin(b, sq, sk, h, d, dv,
                                                     dtype):
    """K1's plain version with ``Dv != D`` (causal, scale ``D ** -0.5``)
    against the JAX models' XLA twin, ``repro.models.attention.
    flash_attention``, the function MLA's prefill calls in the reference.
    Neither the Pallas kernel (one head dim in every block spec) nor
    ``repro.kernels.ref.flash_attention_ref`` (which reshapes its output to
    ``D``) takes ``Dv != D``, so the twin is the only reference here."""
    rng = np.random.default_rng(19)
    qj, qt = _pair_arrays(rng, (b, sq, h, d), dtype)
    kj, kt = _pair_arrays(rng, (b, sk, h, d), dtype)
    vj, vt = _pair_arrays(rng, (b, sk, h, dv), dtype)
    out = ref.flash_attention_ref(qt, kt, vt, causal=True)
    assert out.shape == (b, sq, h, dv) and out.dtype == TORCH[dtype]
    want = jax_attn.flash_attention(qj, kj, vj, causal=True)
    assert max_err(out, want) < FLASH_TOL[dtype]
    # a CPU tensor takes the plain version through the public wrapper
    before = ops.flash_attention.launches
    assert torch.equal(ops.flash_attention(qt, kt, vt, causal=True), out)
    assert ops.flash_attention.launches == before


def test_flash_attention_value_dim_argument_checks():
    """v must share k's batch, length and KV heads; its last dim is free
    on the CPU, and off the CPU only the instantiated (D, Dv) pairs
    reach a kernel."""
    from repro_torch.kernels import _build
    q = torch.zeros(1, 8, 2, 24)
    with pytest.raises(ValueError, match="Dv"):
        ops.flash_attention(q, torch.zeros(1, 8, 2, 24),
                            torch.zeros(1, 7, 2, 16))
    assert ops.flash_attention(q, torch.zeros(1, 8, 2, 24),
                               torch.zeros(1, 8, 2, 16)).shape == \
        (1, 8, 2, 16)
    assert (192, 128) in _build.FLASH_HEAD_DIMS
    assert (24, 16) not in _build.FLASH_HEAD_DIMS
    with pytest.raises(RuntimeError):
        ops.flash_attention(*(torch.zeros(1, 8, 2, d, device="meta")
                              for d in (192, 192, 128)))


# ---------------------------------------------------------------------------
# the MLA block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_lora_rank", [24, 0])
def test_mla_defs_match_reference(q_lora_rank):
    """Same keys, shapes, dtypes and fan-in axes as
    ``repro.models.attention.mla_defs`` (the low-rank query of SMOKE and
    the full-rank ``wq`` path), and a JAX init of the block carried
    across by ``params_from_jax`` unchanged."""
    from repro.configs.archs import SMOKE as JAX_SMOKE
    from repro.models.families import build_model as jax_build_model
    cfg, jcfg = (dataclasses.replace(
        smoke[DEEPSEEK], mla=dataclasses.replace(smoke[DEEPSEEK].mla,
                                                 q_lora_rank=q_lora_rank))
        for smoke in (SMOKE, JAX_SMOKE))
    ours, theirs = attn.mla_defs(cfg), jax_attn.mla_defs(jcfg)
    assert set(ours) == set(theirs)
    assert ("wq" in ours) == (q_lora_rank == 0)
    for k, d in theirs.items():
        assert (ours[k].shape, ours[k].dtype, ours[k].fan_in_axes,
                ours[k].init) == (d.shape, d.dtype, d.fan_in_axes, d.init), k
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(4))
    params = params_from_jax(to_numpy_tree(jparams), cfg, device="cpu")
    for stack in ("dense_blocks", "blocks"):
        for k, leaf in params[stack]["attn"].items():
            want = np.asarray(jparams[stack]["attn"][k].astype(jnp.float32))
            assert np.array_equal(leaf.float().numpy(), want), (stack, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attend_prefill_and_absorbed_decode_match_jax(dtype, pair):
    """One MLA block: a prefill of S positions into a compressed cache of
    S + 4 rows, then three absorbed decode steps, against the reference
    block on the same inputs; the cache is written in place and equals
    the reference's after every call.  Without a cache (the forward
    branch) the block gives the prefill's output."""
    p = pair(DEEPSEEK, dtype)
    cfg = p.cfg
    m = cfg.mla
    rng = np.random.default_rng(29)
    x = rng.standard_normal((B, S + 3, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], p.jparams["dense_blocks"]["attn"])
    tp = {k: v[0] for k, v in p.params["dense_blocks"]["attn"].items()}
    width = m.kv_lora_rank + m.qk_rope_head_dim
    jcache = jnp.zeros((B, S + 4, width), JNP[dtype])
    tcache = torch.zeros((B, S + 4, width), dtype=TORCH[dtype])
    for start, n in ((0, S), (S, 1), (S + 1, 1), (S + 2, 1)):
        xs = x[:, start: start + n]
        jout, jcache = jax_attn.mla_attend(
            jp, p.jcfg, jnp.asarray(xs).astype(JNP[dtype]),
            jnp.arange(start, start + n)[None, :], cache=jcache,
            cache_len=start)
        tout, new_cache = attn.mla_attend(
            tp, cfg, torch.from_numpy(xs).to(TORCH[dtype]),
            torch.arange(start, start + n)[None, :], cache=tcache,
            cache_len=start)
        assert new_cache is tcache and tout.dtype == TORCH[dtype]
        if dtype == "float32":
            assert max_err(tout, jout) < 1e-5, start
            assert max_err(tcache, jcache) < 1e-5, start
        else:
            bar = 0.03 if n > 1 else 0.05
            assert softmax_err(tout, jout) < bar, start
            assert softmax_err(tcache, jcache) < bar, start
        if n > 1:
            free, none = attn.mla_attend(
                tp, cfg, torch.from_numpy(xs).to(TORCH[dtype]),
                torch.arange(n)[None, :])
            assert none is None and torch.equal(free, tout)
    assert bool((tcache[:, S + 3:] == 0).all())


def test_mla_attend_cache_bounds(pair):
    """A prefill starts at an empty cache and must fit it; a decode step
    must find its row in it."""
    p = pair(DEEPSEEK, "float32")
    cfg = p.cfg
    tp = {k: v[0] for k, v in p.params["dense_blocks"]["attn"].items()}
    width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    x = torch.zeros(1, 6, cfg.d_model)
    pos = torch.arange(6)[None, :]
    with pytest.raises(ValueError, match="empty cache"):
        attn.mla_attend(tp, cfg, x, pos, cache=torch.zeros(1, 12, width),
                        cache_len=3)
    with pytest.raises(NotImplementedError, match="do not fit"):
        attn.mla_attend(tp, cfg, x, pos, cache=torch.zeros(1, 5, width))
    with pytest.raises(NotImplementedError, match="does not fit"):
        attn.mla_attend(tp, cfg, x[:, :1], pos[:, :1],
                        cache=torch.zeros(1, 5, width), cache_len=5)


# ---------------------------------------------------------------------------
# DecoderLM with MLA
# ---------------------------------------------------------------------------


def _logits(p, steps=3):
    """Forward over S + steps tokens; prefill of S, then ``steps`` decode
    steps fed the same tokens; in both packages."""
    toks = np.random.default_rng(31).integers(0, p.cfg.vocab_size,
                                              (B, S + steps))
    jt = jnp.asarray(toks)
    jfull = p.jmodel.forward(p.jparams, jt)
    jc = p.jmodel.init_cache(B, S + steps)
    jpre, jc = p.jmodel.prefill(p.jparams, jt[:, :S], jc)
    jdec = []
    for i in range(S, S + steps):
        lg, jc = p.jmodel.decode_step(p.jparams, jt[:, i: i + 1], jc,
                                      jnp.int32(i))
        jdec.append(lg)
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        tfull = p.model.forward(p.params, tt)
        tc = p.model.init_cache(B, S + steps)
        tpre, out = p.model.prefill(p.params, tt[:, :S], tc)
        assert out is tc
        tdec = [p.model.decode_step(p.params, tt[:, i: i + 1], tc, i)[0]
                for i in range(S, S + steps)]
    return (jfull, jpre, jdec, jc), (tfull, tpre, tdec, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decoder_lm_matches_jax(dtype, pair):
    """SMOKE deepseek: forward, prefill and three decode steps against the
    JAX model (the port's decode held to the JAX decode: see the next
    test for why not to its own forward at SMOKE's capacity), and the
    caches after them."""
    p = pair(DEEPSEEK, dtype)
    assert build_model(p.cfg, device="cpu").mla
    (jfull, jpre, jdec, jc), (tfull, tpre, tdec, tc) = _logits(p)
    assert tuple(tfull.shape) == (B, S + 3, p.cfg.vocab_size)
    assert bool(torch.isfinite(tfull.float()).all())
    if dtype == "float32":
        assert max_err(tfull, jfull) < 1e-4
        assert max_err(tpre, jpre) < 1e-4
        for got, want in zip(tdec, jdec):
            assert max_err(got, want) < 1e-4
        for kind in ("dense", "moe"):
            assert max_err(tc[kind]["c"], jc[kind]["c"]) < 1e-4
    else:
        assert softmax_err(tfull, jfull) < 0.03
        assert softmax_err(tpre, jpre) < 0.03
        for got, want in zip(tdec, jdec):
            assert softmax_err(got, want) < 0.05


def test_mla_decode_matches_own_forward_where_nothing_is_dropped(pair):
    """At ``capacity_factor = 8.0`` no MoE layer drops a token, and the
    port's prefill and decode steps give its own forward's logits.  At
    SMOKE's 1.25 they cannot: the forward over S + 3 tokens routes each
    sample at the capacity of S + 3 tokens and drops tokens, while a
    decode step (capacity 8 for one token) never drops; the reference
    departs from its own forward there in the same way.  That is MoE
    capacity semantics, not MLA."""
    moe_cfg = dataclasses.replace(SMOKE[DEEPSEEK].moe, capacity_factor=8.0)
    p = pair(DEEPSEEK, "float32", moe=moe_cfg)
    _, (tfull, tpre, tdec, _) = _logits(p)
    assert max_err(tfull[:, S - 1], tpre[:, 0]) < 1e-4
    for i, got in enumerate(tdec):
        assert max_err(tfull[:, S + i], got[:, 0]) < 1e-4, i


def test_mla_cache_tree_matches_reference(pair):
    """``{"dense": {"c"}, "moe": {"c"}}``, each leaf [layers, B, max_len,
    kv_lora + rope], as the reference's ``cache_defs`` gives it."""
    p = pair(DEEPSEEK, "bfloat16")
    m = p.cfg.mla
    for max_len in (5, 24):
        cache = p.model.init_cache(B, max_len)
        jcache = p.jmodel.init_cache(B, max_len)
        assert set(cache) == set(jcache) == {"dense", "moe"}
        for kind in cache:
            assert set(cache[kind]) == set(jcache[kind]) == {"c"}
            leaf = cache[kind]["c"]
            assert tuple(leaf.shape) == tuple(jcache[kind]["c"].shape) == (
                1 if kind == "dense" else p.cfg.num_layers - 1, B, max_len,
                m.kv_lora_rank + m.qk_rope_head_dim)
            assert leaf.dtype == torch.bfloat16 and not bool(leaf.any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_device_position_equals_int_position(dtype, pair):
    """Decode steps at a 0-d int64 position tensor (the captured graph's,
    advanced in place) give the logits and caches of the same steps at
    Python ints, bitwise."""
    p = pair(DEEPSEEK, dtype)
    toks = torch.from_numpy(p.tokens)
    with torch.inference_mode():
        caches = [p.model.init_cache(B, S + 1), p.model.init_cache(B, S + 1)]
        for c in caches:
            p.model.prefill(p.params, toks[:, :S - 2], c)
        pos = torch.tensor(S - 2)
        for i in range(S - 2, S + 1):
            want, _ = p.model.decode_step(p.params, toks[:, i: i + 1],
                                          caches[0], i)
            got, _ = p.model.decode_step(p.params, toks[:, i: i + 1],
                                         caches[1], pos)
            assert torch.equal(got, want), i
            pos.add_(1)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(caches[1]), tree_leaves(caches[0])))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deepseek_engines():
    """deepseek and qwen3 SMOKE bundles in float32, JAX and port."""
    return _float32_bundles(DEEPSEEK, "qwen3-1.7b")


@pytest.mark.parametrize("policy,n_devices", [("FATE", 2),
                                              ("RoundRobin", 1)])
def test_mla_workflow_same_greedy_tokens_as_jax_engine(deepseek_engines,
                                                       policy, n_devices):
    """deepseek serves retrieve, work_b and merge, qwen3 work_a, at prompt
    7: the same greedy tokens as the JAX engine for every stage, each
    decode step in the key's compressed static cache."""
    _same_tokens_at_prompt_7(deepseek_engines, policy, n_devices)
    bundle = deepseek_engines[1]["qwen-7b"]
    m = bundle.cfg.mla
    assert bundle.decoder.slots
    for (batch, max_len), slot in bundle.decoder.slots.items():
        assert set(slot.cache) == {"dense", "moe"}
        for kind in ("dense", "moe"):
            c = slot.cache[kind]["c"]
            assert tuple(c.shape[1:]) == \
                (batch, max_len, m.kv_lora_rank + m.qk_rope_head_dim)
            assert bool(c[:, :, : max_len - 1].any())
