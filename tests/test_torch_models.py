"""The port's layers, GQA block, MoE layer, Mamba2 block, DecoderLM,
RWKVLM and Mamba2Hybrid against the JAX package, from converted
parameters, on the SMOKE configs of the GQA family (dense, MoE and
gemma3's local/global interleave), of rwkv6 and of zamba2.

The same inputs (numpy, seeded) go through both.  On the CPU the port's
attention goes through the plain versions of its kernels, which keep
``p`` in float32 as the TPU kernels do, while the JAX models run XLA twins
that round ``p`` to the value dtype; so parity is tight in float32
(logits to 1e-4: two frameworks summing in different orders over two
layers) and loose in bfloat16 (softmax to the 0.03 / 0.05 of
``tests/test_smoke_archs.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import SMOKE as JAX_SMOKE
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.models.families import build_model as jax_build_model
from repro_torch.configs.archs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.families import build_model

ARCHS = ["qwen3-1.7b", "glm4-9b", "qwen1.5-4b", "llava-next-mistral-7b",
         "granite-moe-3b-a800m"]
# the model-level cases run on these (whisper's encoder-decoder:
# tests/test_torch_whisper.py; deepseek-v2: tests/test_torch_mla.py)
MODELS = ARCHS + ["gemma3-4b", "rwkv6-3b", "zamba2-2.7b"]
B, S = 2, 16


def to_numpy_tree(tree):
    """A JAX param tree as float32 numpy arrays (bf16 widens exactly)."""
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def npy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(x.astype(jnp.float32))      # a writable copy


def max_err(a, b) -> float:
    return float(np.max(np.abs(npy(a) - npy(b))))


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]


def softmax_err(a, b) -> float:
    sa = torch.softmax(torch.from_numpy(npy(a)), -1)
    sb = torch.softmax(torch.from_numpy(npy(b)), -1)
    return float((sa - sb).abs().max())


class Pair:
    """One config built in both packages from the same parameters."""

    def __init__(self, arch: str, dtype: str, **over):
        self.jcfg = dataclasses.replace(JAX_SMOKE[arch], dtype=dtype, **over)
        self.cfg = dataclasses.replace(SMOKE[arch], dtype=dtype, **over)
        self.jmodel = jax_build_model(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(1))
        # biases and norm weights are zero-initialised: perturb them so
        # that the test sees them
        rng = np.random.default_rng(11)
        self.jparams = jax.tree.map(
            lambda x: x + jnp.asarray(
                0.1 * rng.standard_normal(x.shape, dtype=np.float32)
            ).astype(x.dtype) if x.ndim <= 3 and x.size < 4096 else x,
            self.jparams)
        self.model = build_model(self.cfg, device="cpu")
        self.params = params_from_jax(to_numpy_tree(self.jparams), self.cfg,
                                      device="cpu")
        rng = np.random.default_rng(5)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, S + 1))
        self.extra = None
        if self.cfg.family == "vlm":
            self.extra = rng.standard_normal(
                (B, self.cfg.num_patches, self.cfg.d_model),
                dtype=np.float32)

    def jax_extra(self):
        return None if self.extra is None else jnp.asarray(self.extra)

    def torch_extra(self):
        return None if self.extra is None else torch.from_numpy(self.extra)


_PAIRS: dict = {}


@pytest.fixture(scope="module")
def pair():
    """Factory with a per-module cache: ``pair(arch, dtype)``."""
    def get(arch, dtype, **over):
        key = (arch, dtype, tuple(sorted(over.items())))
        if key not in _PAIRS:
            _PAIRS[key] = Pair(arch, dtype, **over)
        return _PAIRS[key]
    yield get
    _PAIRS.clear()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 4e-2)])
def test_rms_norm_matches_jax(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3.0
    gamma = rng.standard_normal(64, dtype=np.float32) * 0.2
    want = jax_layers.rms_norm(jnp.asarray(x).astype(dtype),
                               jnp.asarray(gamma), 1e-6)
    got = layers.rms_norm(torch.from_numpy(x).to(layers.torch_dtype(dtype)),
                          torch.from_numpy(gamma), 1e-6)
    assert got.dtype == layers.torch_dtype(dtype)
    assert max_err(got, want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 4e-2)])
@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_matches_jax(dtype, tol, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16), dtype=np.float32)
    pos = np.arange(9)[None, :] + 7
    want = jax_layers.apply_rope(jnp.asarray(x).astype(dtype),
                                 jnp.asarray(pos), theta)
    got = layers.apply_rope(
        torch.from_numpy(x).to(layers.torch_dtype(dtype)),
        torch.from_numpy(pos), theta)
    assert max_err(got, want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 6e-2)])
def test_swiglu_matches_jax(dtype, tol):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    ws = [rng.standard_normal(s, dtype=np.float32) / np.sqrt(s[0])
          for s in ((32, 64), (32, 64), (64, 32))]
    want = jax_layers.swiglu(jnp.asarray(x).astype(dtype),
                             *[jnp.asarray(w).astype(dtype) for w in ws])
    dt = layers.torch_dtype(dtype)
    got = layers.swiglu(torch.from_numpy(x).to(dt),
                        *[torch.from_numpy(w).to(dt) for w in ws])
    assert max_err(got, want) < tol


def test_unembed_logits_both_layouts():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 8), dtype=np.float32)
    w = rng.standard_normal((11, 8), dtype=np.float32)
    for transpose, wm in ((True, w), (False, w.T.copy())):
        want = jax_layers.unembed_logits(jnp.asarray(x), jnp.asarray(wm),
                                         transpose)
        got = layers.unembed_logits(torch.from_numpy(x),
                                    torch.from_numpy(wm), transpose)
        assert max_err(got, want) < 1e-5


@pytest.mark.parametrize("arch", MODELS)
def test_param_tree_lines_up_with_jax(arch, pair):
    """Same keys, shapes and dtypes as the JAX package's tree, and the
    port's own init is deterministic in its generator's seed."""
    p = pair(arch, "bfloat16")
    jleaves = jax.tree_util.tree_flatten_with_path(p.jparams)[0]
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat[path] = node
    walk(p.params, ())
    assert len(flat) == len(jleaves)
    for path, leaf in jleaves:
        key = tuple(k.key for k in path)
        assert tuple(flat[key].shape) == tuple(leaf.shape), key
        assert str(flat[key].dtype).split(".")[-1] == str(leaf.dtype), key
    own = [p.model.init(torch.Generator().manual_seed(3)) for _ in range(2)]
    a, b = (tree_leaves(t) for t in own)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [tuple(x.shape) for x in a] == \
        [tuple(x.shape) for x in tree_leaves(p.params)]


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_attend_prefill_and_decode_match_jax(arch, pair):
    p = pair(arch, "float32")
    cfg = p.cfg
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], p.jparams["blocks"]["attn"])
    tp = {k: v[0] for k, v in p.params["blocks"]["attn"].items()}
    shape = (B, S + 4, cfg.num_kv_heads, cfg.resolved_head_dim)

    jcache = (jnp.zeros(shape), jnp.zeros(shape))
    jout, jcache = jax_attn.gqa_attend(
        jp, p.jcfg, jnp.asarray(x), jnp.arange(S)[None, :],
        cache=jcache, cache_len=0)
    jout1, jcache = jax_attn.gqa_attend(
        jp, p.jcfg, jnp.asarray(x1), jnp.full((1, 1), S),
        cache=jcache, cache_len=S)

    tcache = (torch.zeros(shape), torch.zeros(shape))
    tout, new_cache = attn.gqa_attend(
        tp, cfg, torch.from_numpy(x), torch.arange(S)[None, :],
        cache=tcache, cache_len=0)
    assert new_cache[0] is tcache[0]          # updated in place
    tout1, _ = attn.gqa_attend(
        tp, cfg, torch.from_numpy(x1), torch.full((1, 1), S),
        cache=tcache, cache_len=S)
    assert max_err(tout, jout) < 1e-5
    assert max_err(tout1, jout1) < 1e-5
    assert max_err(tcache[0], jcache[0]) < 1e-5
    assert max_err(tcache[1], jcache[1]) < 1e-5
    # no cache: the training / forward branch
    tfree, none = attn.gqa_attend(tp, cfg, torch.from_numpy(x),
                                  torch.arange(S)[None, :])
    assert none is None and max_err(tfree, jout) < 1e-5


def test_gqa_attend_window_and_mla_wait(pair):
    """A sliding window takes a ring of at most ``window`` rows; a linear
    cache must hold every position (only a window's cache keeps a tail);
    sequence-parallel prefill waits for its ROADMAP item (MLA is served
    since it was ported: ``tests/test_torch_mla.py``)."""
    p = pair("qwen3-1.7b", "float32")
    cfg = p.cfg
    tp = {k: v[0] for k, v in p.params["blocks"]["attn"].items()}
    x = torch.zeros(1, 6, cfg.d_model)
    pos = torch.arange(6)[None, :]

    def cache(rows):
        shape = (1, rows, cfg.num_kv_heads, cfg.resolved_head_dim)
        return torch.zeros(shape), torch.zeros(shape)
    with pytest.raises(ValueError, match="at most 4 rows"):
        attn.gqa_attend(tp, cfg, x, pos, window=4, cache=cache(5))
    with pytest.raises(NotImplementedError, match="sliding window"):
        attn.gqa_attend(tp, cfg, x, pos, cache=cache(5))
    with pytest.raises(NotImplementedError, match="sliding window"):
        attn.gqa_attend(tp, cfg, x[:, :1], pos[:, :1], cache=cache(5),
                        cache_len=5)
    out, ring = attn.gqa_attend(tp, cfg, x, pos, window=4, cache=cache(4))
    assert out.shape == x.shape and ring[0].shape[1] == 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attn.flash_attention_sp()


# ---------------------------------------------------------------------------
# DecoderLM
# ---------------------------------------------------------------------------


def _jax_logits(p):
    toks = jnp.asarray(p.tokens)
    full = p.jmodel.forward(p.jparams, toks, p.jax_extra())
    cache = p.jmodel.init_cache(B, 2 * S)
    pre, cache = p.jmodel.prefill(p.jparams, toks[:, :S], cache,
                                  p.jax_extra())
    dec, _ = p.jmodel.decode_step(p.jparams, toks[:, S: S + 1], cache,
                                  jnp.int32(S))
    return full, pre, dec


@torch.inference_mode()
def _torch_logits(p):
    toks = torch.from_numpy(p.tokens)
    full = p.model.forward(p.params, toks, p.torch_extra())
    cache = p.model.init_cache(B, 2 * S)
    pre, cache = p.model.prefill(p.params, toks[:, :S], cache,
                                 p.torch_extra())
    dec, _ = p.model.decode_step(p.params, toks[:, S: S + 1], cache, S)
    return full, pre, dec


@pytest.mark.parametrize("arch", MODELS)
def test_decoder_lm_float32_logits_match_jax(arch, pair):
    p = pair(arch, "float32")
    jfull, jpre, jdec = _jax_logits(p)
    tfull, tpre, tdec = _torch_logits(p)
    assert tuple(tfull.shape) == (B, S + 1, p.cfg.vocab_size)
    assert tuple(tpre.shape) == tuple(tdec.shape) == (B, 1, p.cfg.vocab_size)
    assert max_err(tfull, jfull) < 1e-4
    assert max_err(tpre, jpre) < 1e-4
    assert max_err(tdec, jdec) < 1e-4


@pytest.mark.parametrize("arch", MODELS)
def test_decoder_lm_bfloat16_softmax_matches_jax(arch, pair):
    p = pair(arch, "bfloat16")
    jfull, jpre, jdec = _jax_logits(p)
    tfull, tpre, tdec = _torch_logits(p)
    assert tfull.dtype == torch.bfloat16
    assert bool(torch.isfinite(tfull.float()).all())
    assert softmax_err(tfull, jfull) < 0.03
    assert softmax_err(tpre, jpre) < 0.03
    assert softmax_err(tdec, jdec) < 0.05


@pytest.mark.parametrize("arch", MODELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_consistent_with_forward(arch, dtype, pair):
    """The port's own prefill + decode against its full forward."""
    p = pair(arch, dtype)
    full, pre, dec = _torch_logits(p)
    if dtype == "float32":
        assert max_err(full[:, S - 1], pre[:, 0]) < 1e-4
        assert max_err(full[:, S], dec[:, 0]) < 1e-4
    else:
        assert softmax_err(full[:, S - 1], pre[:, 0]) < 0.03
        assert softmax_err(full[:, S], dec[:, 0]) < 0.05


def test_decode_steps_write_cache_in_place(pair):
    p = pair("qwen3-1.7b", "float32")
    toks = torch.from_numpy(p.tokens)
    with torch.inference_mode():
        cache = p.model.init_cache(B, S + 2)
        k = cache["blocks"]["k"]
        _, out = p.model.prefill(p.params, toks[:, :S], cache)
        assert out["blocks"]["k"] is k
        assert bool((k[:, :, :S] != 0).any()) and bool((k[:, :, S:] == 0).all())
        p.model.decode_step(p.params, toks[:, S: S + 1], cache, S)
        assert bool((k[:, :, S] != 0).any()) and bool((k[:, :, S + 1] == 0).all())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m",
                                  "rwkv6-3b", "zamba2-2.7b", "gemma3-4b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_device_position_equals_int_position(arch, dtype,
                                                         pair):
    """Dense, MoE, RWKV6, Mamba2 hybrid and gemma3 (its local layers' ring
    wrapping: a prompt of 14 over a window of 8): decode steps at a 0-d int64
    position tensor (the captured graph's, advanced in place) give the
    logits and caches of the same steps at Python ints, bitwise."""
    p = pair(arch, dtype)
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


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(SMOKE["qwen3-1.7b"])


def test_convert_rejects_mismatched_trees(pair):
    p = pair("qwen3-1.7b", "float32")
    tree = to_numpy_tree(p.jparams)
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, p.cfg, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, p.cfg, device="cpu")


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-3b-a800m"
SHARED_MOE = dict(
    moe=dataclasses.replace(SMOKE[GRANITE].moe, num_shared_experts=1,
                            d_shared=32),
    moe_layer_start=1)


@pytest.mark.parametrize("variant", ["routed", "shared"])
def test_apply_moe_matches_jax_with_dropped_tokens(variant, pair):
    """S = 64 with capacity factor 0.5: capacity 16 for 128 (token,
    expert) pairs over 4 experts, so tokens are dropped; the shared
    expert adds its dense FFN."""
    over = SHARED_MOE if variant == "shared" else {}
    p = pair(GRANITE, "float32", **over)
    m = dataclasses.replace(p.cfg.moe, capacity_factor=0.5)
    cfg = dataclasses.replace(p.cfg, moe=m)
    jcfg = dataclasses.replace(p.jcfg, moe=dataclasses.replace(
        p.jcfg.moe, capacity_factor=0.5))
    assert moe._capacity(64, cfg) == 16
    x = np.random.default_rng(21).standard_normal(
        (B, 64, cfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], p.jparams["blocks"]["moe"])
    tp = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in p.params["blocks"]["moe"].items()}
    assert ("shared" in tp) == (variant == "shared")
    want = jax_moe.apply_moe(jp, jcfg, jnp.asarray(x))
    got = moe.apply_moe(tp, cfg, torch.from_numpy(x))
    assert got.shape == (B, 64, cfg.d_model)
    assert max_err(got, want) < 1e-5
    # tokens were dropped: some per-expert load exceeds the capacity
    logits = torch.from_numpy(x) @ tp["router"]
    top_e = torch.topk(torch.softmax(logits, -1), m.top_k, -1).indices
    load = torch.nn.functional.one_hot(top_e, m.num_experts).sum((1, 2))
    assert int(load.max()) > 16


def test_moe_route_holds_given_experts(pair):
    """``route`` picks the top-k experts, or takes them as given and
    renormalises their gates (a measurement's way of holding two runs to
    one routing)."""
    p = pair(GRANITE, "float32")
    rp = {"router": p.params["blocks"]["moe"]["router"][0]}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 5, p.cfg.d_model), dtype=np.float32))
    g, e = moe.route(rp, p.cfg, x)
    assert e.shape == (B, 5, p.cfg.moe.top_k)
    assert torch.allclose(g.sum(-1), torch.ones(B, 5))
    g2, e2 = moe.route(rp, p.cfg, x, experts=e)
    assert torch.equal(e2, e) and torch.allclose(g2, g)
    other = torch.flip(e, dims=[-1]) if p.cfg.moe.top_k > 1 else e
    g3, _ = moe.route(rp, p.cfg, x, experts=other)
    assert torch.allclose(g3, torch.flip(g, dims=[-1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_with_dense_first_layer_and_shared_experts(dtype, pair):
    """``moe_layer_start = 1``: a ``dense_blocks`` stack before the MoE
    ``blocks``, caches ``{"dense", "moe"}``; logits against the JAX model
    and prefill/decode against forward."""
    p = pair(GRANITE, dtype, **SHARED_MOE)
    assert set(p.params) >= {"dense_blocks", "blocks"}
    assert "ffn" in p.params["dense_blocks"]
    assert "shared" in p.params["blocks"]["moe"]
    jfull, jpre, jdec = _jax_logits(p)
    tfull, tpre, tdec = _torch_logits(p)
    cache = p.model.init_cache(B, 4)
    assert set(cache) == {"dense", "moe"}
    assert cache["dense"]["k"].shape[0] == 1
    assert cache["moe"]["k"].shape[0] == p.cfg.num_layers - 1
    if dtype == "float32":
        assert max_err(tfull, jfull) < 1e-4
        assert max_err(tpre, jpre) < 1e-4
        assert max_err(tdec, jdec) < 1e-4
        assert max_err(tfull[:, S], tdec[:, 0]) < 1e-4
    else:
        assert softmax_err(tfull, jfull) < 0.03
        assert softmax_err(tdec, jdec) < 0.05


# ---------------------------------------------------------------------------
# RWKVLM
# ---------------------------------------------------------------------------

RWKV = "rwkv6-3b"


def _rwkv_logits_both(p, plen):
    """Prefill over ``plen`` tokens (not a chunk multiple), two decode
    steps, and the full forward, in both packages."""
    toks = p.tokens[:, : plen + 2]
    jcache = p.jmodel.init_cache(B, 0)
    jpre, jcache = p.jmodel.prefill(p.jparams, jnp.asarray(toks[:, :plen]),
                                    jcache)
    jdec = []
    for i in range(2):
        lg, jcache = p.jmodel.decode_step(
            p.jparams, jnp.asarray(toks[:, plen + i: plen + i + 1]), jcache,
            jnp.int32(plen + i))
        jdec.append(lg)
    jfull = p.jmodel.forward(p.jparams, jnp.asarray(toks))
    with torch.inference_mode():
        tt = torch.from_numpy(toks)
        cache = p.model.init_cache(B, 0)
        tpre, out = p.model.prefill(p.params, tt[:, :plen], cache)
        assert out is cache
        tdec = []
        for i in range(2):
            lg, cache = p.model.decode_step(
                p.params, tt[:, plen + i: plen + i + 1], cache, plen + i)
            tdec.append(lg)
        tfull = p.model.forward(p.params, tt)
    return (jpre, jdec, jfull, jcache), (tpre, tdec, tfull, cache)


@pytest.mark.parametrize("plen", [7, 10])
def test_rwkv_prefill_pads_and_decodes_like_jax(plen, pair):
    p = pair(RWKV, "float32")
    assert plen % p.cfg.rwkv.chunk
    (jpre, jdec, jfull, jcache), (tpre, tdec, tfull, cache) = \
        _rwkv_logits_both(p, plen)
    assert max_err(tpre, jpre) < 1e-4
    for a, b in zip(tdec, jdec):
        assert max_err(a, b) < 1e-4
    assert max_err(tfull, jfull) < 1e-4
    # the port's own prefill + decode against its forward
    assert max_err(tfull[:, plen - 1], tpre[:, 0]) < 1e-4
    assert max_err(tfull[:, plen + 1], tdec[1][:, 0]) < 1e-4
    for key in ("shift", "wkv", "cshift"):
        assert max_err(cache[key], jcache[key]) < 1e-4


def test_rwkv_strong_decay_through_the_model(pair):
    """decay_base = 3 makes w = exp(-exp(3 + ...)) far below 1e-6: the
    model's clamp holds it at 1e-6, the scan stays finite and equal to
    the JAX model."""
    base = pair(RWKV, "float32")
    p = Pair(RWKV, "float32")
    p.jparams["blocks"]["time"]["decay_base"] = jnp.full_like(
        base.jparams["blocks"]["time"]["decay_base"], 3.0)
    p.params = params_from_jax(to_numpy_tree(p.jparams), p.cfg,
                               device="cpu")
    (jpre, jdec, jfull, _), (tpre, tdec, tfull, _) = _rwkv_logits_both(p, 7)
    assert bool(torch.isfinite(tfull).all())
    assert max_err(tfull, jfull) < 1e-4
    assert max_err(tpre, jpre) < 1e-4
    assert max_err(tdec[1], jdec[1]) < 1e-4


# ---------------------------------------------------------------------------
# Mamba2 block and Mamba2Hybrid
# ---------------------------------------------------------------------------

ZAMBA = "zamba2-2.7b"


def _ssm_layer(p, i=0):
    """Layer ``i``'s Mamba2 params in both packages."""
    jp = jax.tree.map(lambda a: a[i], p.jparams["blocks"]["ssm"])
    tp = {k: v[i] for k, v in p.params["blocks"]["ssm"].items()}
    return jp, tp


@pytest.mark.parametrize("seq", [7, 8])
def test_mamba2_forward_with_state_then_decode_match_jax(seq, pair):
    """One Mamba2 block from a non-zero carried state: prefill over
    ``seq`` steps (chunk 4: padding on at 7, off at 8) through the scan,
    then one decode step, against the JAX block; the conv as well."""
    p = pair(ZAMBA, "float32")
    cfg, jcfg = p.cfg, p.jcfg
    jp, tp = _ssm_layer(p, 1)
    rng = np.random.default_rng(30 + seq)
    x = rng.standard_normal((B, seq, cfg.d_model), dtype=np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    shapes = ssm.mamba2_state_defs(cfg, B)
    st = {k: rng.standard_normal(shape, dtype=np.float32) * 0.5
          for k, (shape, _) in shapes.items()}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    jout, jst = jax_ssm.mamba2_forward(jp, jcfg, jnp.asarray(x), state=jst)
    jout1, jst1 = jax_ssm.mamba2_decode(jp, jcfg, jnp.asarray(x1), jst)
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    tout, tst = ssm.mamba2_forward(tp, cfg, torch.from_numpy(x), state=tst)
    tout1, tst1 = ssm.mamba2_decode(tp, cfg, torch.from_numpy(x1), tst)
    assert tuple(tout.shape) == (B, seq, cfg.d_model)
    for got, want in ((tout, jout), (tout1, jout1),
                      (tst["ssm"], jst["ssm"]), (tst["conv"], jst["conv"]),
                      (tst1["ssm"], jst1["ssm"])):
        assert max_err(got, want) < 1e-4
    # no state: the forward branch of the reference's stack
    free, _ = ssm.mamba2_forward(tp, cfg, torch.from_numpy(x))
    jfree, _ = jax_ssm.mamba2_forward(jp, jcfg, jnp.asarray(x))
    assert max_err(free, jfree) < 1e-4


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_causal_conv_matches_jax(dtype, tol):
    """Both dtypes against the JAX conv (bf16: one rounding of the
    output, H18)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32) * 0.3
    hist = rng.standard_normal((2, 3, 12), dtype=np.float32)
    dt = layers.torch_dtype(dtype)
    for st in (None, hist):
        want, wnew = jax_ssm._causal_conv(
            jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype),
            None if st is None else jnp.asarray(st))
        got, new = ssm._causal_conv(
            torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt),
            None if st is None else torch.from_numpy(st))
        assert got.dtype == dt
        assert max_err(got, want) < tol
        assert max_err(new, wnew) < tol


def _hybrid_both(p, plen, steps=3):
    """Prefill over ``plen`` tokens then ``steps`` decode steps, in both
    packages; returns the logits and the final caches."""
    toks = p.tokens[:, : plen + steps]
    jcache = p.jmodel.init_cache(B, plen + steps)
    jpre, jcache = p.jmodel.prefill(p.jparams, jnp.asarray(toks[:, :plen]),
                                    jcache)
    jdec = []
    for i in range(steps):
        lg, jcache = p.jmodel.decode_step(
            p.jparams, jnp.asarray(toks[:, plen + i: plen + i + 1]), jcache,
            jnp.int32(plen + i))
        jdec.append(lg)
    with torch.inference_mode():
        tt = torch.from_numpy(toks)
        cache = p.model.init_cache(B, plen + steps)
        tpre, out = p.model.prefill(p.params, tt[:, :plen], cache)
        assert out is cache
        tdec = []
        for i in range(steps):
            lg, cache = p.model.decode_step(
                p.params, tt[:, plen + i: plen + i + 1], cache, plen + i)
            tdec.append(lg)
    return (jpre, jdec, jcache), (tpre, tdec, cache)


@pytest.mark.parametrize("plen", [7, 8])
def test_hybrid_prefill_and_decode_match_jax(plen, pair):
    """SMOKE zamba2 (5 layers, attention after layers 2 and 4, one tail
    layer): prefill at a length that is (8) and is not (7) a multiple of
    the chunk (4), then decode steps, logits and every cache leaf against
    the JAX model."""
    p = pair(ZAMBA, "float32")
    assert p.model.n_attn == 2
    assert p.cfg.num_layers % p.cfg.attn_every == 1     # a tail layer
    (jpre, jdec, jcache), (tpre, tdec, cache) = _hybrid_both(p, plen)
    assert max_err(tpre, jpre) < 1e-4
    for a, b in zip(tdec, jdec):
        assert max_err(a, b) < 1e-4
    # cache leaves to 1e-5 of their largest magnitude (the k rows reach
    # about 11, where 1e-4 is a few float32 steps)
    for group, key in (("ssm", "ssm"), ("ssm", "conv"), ("kv", "k"),
                       ("kv", "v")):
        got, want = cache[group][key], jcache[group][key]
        assert got.shape == want.shape
        assert max_err(got, want) < 1e-5 * max(1.0, float(np.abs(npy(want)).max()))


def test_hybrid_cache_written_in_place(pair):
    p = pair(ZAMBA, "float32")
    toks = torch.from_numpy(p.tokens)
    with torch.inference_mode():
        cache = p.model.init_cache(B, S + 2)
        leaves = {(g, k): v for g in cache for k, v in cache[g].items()}
        _, out = p.model.prefill(p.params, toks[:, :S], cache)
        for (g, k), leaf in leaves.items():
            assert out[g][k] is leaf
            assert bool((leaf != 0).any()), (g, k)
        k_cache = cache["kv"]["k"]
        assert bool((k_cache[:, :, S:] == 0).all())
        ssm_before = cache["ssm"]["ssm"].clone()
        p.model.decode_step(p.params, toks[:, S: S + 1], cache, S)
        assert bool((k_cache[:, :, S] != 0).any())
        assert bool((k_cache[:, :, S + 1] == 0).all())
        assert not torch.equal(cache["ssm"]["ssm"], ssm_before)


def test_convert_takes_the_hybrid_tree(pair):
    """``blocks`` stacked over the layers, ``shared_attn`` not stacked."""
    p = pair(ZAMBA, "bfloat16")
    cfg = p.cfg
    assert p.params["blocks"]["ssm"]["w_in"].shape[0] == cfg.num_layers
    assert p.params["blocks"]["ssm"]["a_log"].dtype == torch.float32
    wq = p.params["shared_attn"]["attn"]["wq"]
    assert tuple(wq.shape) == (cfg.d_model, cfg.num_heads,
                               cfg.resolved_head_dim)
    assert wq.dtype == torch.bfloat16
    tree = to_numpy_tree(p.jparams)
    bad = dict(tree, shared_attn={k: v for k, v in tree["shared_attn"].items()
                                  if k != "ffn"})
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, cfg, device="cpu")
