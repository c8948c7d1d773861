"""whisper-small's encoder-decoder (``EncDecLM``) in the port against the
JAX package, on SMOKE whisper (2 encoder and 2 decoder layers, d 64, 4
heads / 2 KV heads of 16, 12 frames, vocab 256): the parameter tree and
the cache, ``encode``, ``forward``, a prefill followed by decode steps,
the cross-attention's decode against the reference's ``flash_attention``
at one query, which kernel each attention call reaches, device positions
against int positions, the serving layer's static decode, and the
``ValueError`` without frames.

Parameters, tokens and frames come from numpy with a seed, through the
twin of ``tests/test_torch_smoke_archs.py`` (whose note says why the GQA
projections are drawn at their input width).  Bars: float32 logits to
1e-4, bfloat16 softmax to 0.03 (prefill, forward) and 0.05 (decode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.core.planner import Placement
from repro_torch.core.workflow import Stage, Workflow
from repro_torch.kernels import ops
from repro_torch.models.families import EncDecLM
from repro_torch.serving.engine import ModelBundle, ServingEngine
from repro_torch.serving.graphs import DecodeGraphs, StaticDecode
from test_torch_smoke_archs import Twin, _npy, _softmax_err

ARCH = "whisper-small"
B, P, STEPS = 2, 8, 4
MAX_LEN = P + STEPS + 1
DTYPES = ["float32", "bfloat16"]


class Whisper(Twin):
    """SMOKE whisper in both packages from the same numpy parameters
    (the twin of ``tests/test_torch_smoke_archs.py``), its first
    P + STEPS tokens and its frames."""

    def __init__(self, dtype: str):
        super().__init__(ARCH, dtype)
        self.tokens = self.tokens[:, : P + STEPS]
        self.frames = self.extra

    def t(self, x):
        return torch.from_numpy(np.asarray(x))

    def jax_steps(self):
        """The JAX model's prefill logits and those of STEPS decode steps
        fed ``tokens[:, P:]`` (teacher-forced)."""
        m, toks = self.jmodel, jnp.asarray(self.tokens)
        cache = m.init_cache(B, MAX_LEN)
        out, cache = m.prefill(self.jparams, toks[:, :P], cache,
                               jnp.asarray(self.frames))
        logits = [out]
        for i in range(STEPS):
            out, cache = m.decode_step(self.jparams, toks[:, P + i: P + i + 1],
                                       cache, jnp.int32(P + i))
            logits.append(out)
        return logits

    @torch.inference_mode()
    def torch_steps(self, pos=None):
        """The same with the port, at int positions, or at the 0-d int64
        position ``pos`` advanced in place; also returns the cache."""
        toks = self.t(self.tokens)
        cache = self.model.init_cache(B, MAX_LEN)
        out, cache = self.model.prefill(self.params, toks[:, :P], cache,
                                        self.t(self.frames))
        logits = [out]
        for i in range(STEPS):
            out, _ = self.model.decode_step(
                self.params, toks[:, P + i: P + i + 1], cache,
                P + i if pos is None else pos)
            if pos is not None:
                pos.add_(1)
            logits.append(out)
        return logits, cache


_MODELS: dict = {}


@pytest.fixture(scope="module")
def whisper():
    def get(dtype):
        if dtype not in _MODELS:
            _MODELS[dtype] = Whisper(dtype)
        return _MODELS[dtype]
    yield get
    _MODELS.clear()


def _err(a, b) -> float:
    return float(np.max(np.abs(_npy(a) - _npy(b))))


def test_param_tree_and_cache_line_up_with_jax(whisper):
    """The reference's keys, shapes and dtypes (``params_from_jax`` takes
    its tree unchanged), its cache layout, and a deterministic own init."""
    w = whisper("bfloat16")
    assert isinstance(w.model, EncDecLM)
    flat = {}

    def walk(node, path, out):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), out)
        else:
            out[path] = node
    walk(w.params, (), flat)
    jflat = {}
    walk(w.jmodel.init(jax.random.PRNGKey(0)), (), jflat)
    assert set(flat) == set(jflat)
    for key, leaf in jflat.items():
        assert tuple(flat[key].shape) == tuple(leaf.shape), key
        assert str(flat[key].dtype).split(".")[-1] == str(leaf.dtype), key
    assert set(w.params) == {"embed", "pos_enc", "ln_f", "ln_enc", "head",
                             "encoder", "decoder"}
    assert set(w.params["decoder"]) - set(w.params["encoder"]) == \
        {"ln_cross", "cross"}
    cache, jcache = {}, {}
    walk(w.model.init_cache(B, MAX_LEN), (), cache)
    walk(w.jmodel.init_cache(B, MAX_LEN), (), jcache)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert tuple(cache[("enc_out",)].shape) == (B, 12, 64)
    own = [w.model.init(torch.Generator().manual_seed(3)) for _ in range(2)]
    a, b = {}, {}
    walk(own[0], (), a)
    walk(own[1], (), b)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_jax(dtype, whisper):
    w = whisper(dtype)
    with torch.inference_mode():
        got = w.model.encode(w.params, w.t(w.frames))
    want = w.jmodel.encode(w.jparams, jnp.asarray(w.frames), remat=False)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, w.cfg.encoder_frames, w.cfg.d_model)
    # the encoder's output is rms-normed: unit scale, so one bf16 step
    # of its largest values is 2**-6
    assert _err(got, want) < (1e-4 if dtype == "float32" else 0.1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype, whisper):
    w = whisper(dtype)
    with torch.inference_mode():
        got = w.model.forward(w.params, w.t(w.tokens), w.t(w.frames))
    want = w.jmodel.forward(w.jparams, jnp.asarray(w.tokens),
                            jnp.asarray(w.frames))
    assert tuple(got.shape) == (B, P + STEPS, w.cfg.vocab_size)
    if dtype == "float32":
        assert _err(got, want) < 1e-4
    else:
        assert _softmax_err(got, want) < 0.03


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_steps_match_jax(dtype, whisper):
    """A prefill of P tokens and STEPS teacher-forced decode steps: the
    same logits as the JAX model at every step, and the same greedy
    tokens in float32."""
    w = whisper(dtype)
    got, _ = w.torch_steps()
    want = w.jax_steps()
    for i, (g, j) in enumerate(zip(got, want)):
        assert tuple(g.shape) == (B, 1, w.cfg.vocab_size)
        if dtype == "float32":
            assert _err(g, j) < 1e-4, i
            assert np.array_equal(_npy(g).argmax(-1), _npy(j).argmax(-1))
        else:
            assert _softmax_err(g, j) < (0.03 if i == 0 else 0.05), i


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_decode_is_reference_flash_at_one_query(dtype,
                                                                whisper):
    """A decode step's cross-attention takes decode_attention (K2's plain
    version here) at the int length Sk: the reference's
    ``flash_attention(q, k, v, causal=False)`` with one query row, alone
    and inside the block's ``_cross_attend``."""
    w = whisper(dtype)
    cfg, dt = w.cfg, getattr(torch, dtype)
    rng = np.random.default_rng(7)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    sk = cfg.encoder_frames
    q = rng.standard_normal((B, 1, h, d), dtype=np.float32)
    k = rng.standard_normal((B, sk, kv, d), dtype=np.float32)
    v = rng.standard_normal((B, sk, kv, d), dtype=np.float32)
    got = ops.decode_attention(*(w.t(x).to(dt) for x in (q, k, v)), sk)
    want = jax_attn.flash_attention(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)), causal=False)
    # bf16: the XLA twin rounds p to bf16, the plain version does not
    assert _err(got, want) < (1e-5 if dtype == "float32" else 2e-2)
    x = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((B, sk, cfg.d_model), dtype=np.float32)
    tp = {k_: v_[0] for k_, v_ in w.params["decoder"]["cross"].items()}
    jp = {k_: v_[0] for k_, v_ in w.jparams["decoder"]["cross"].items()}
    with torch.inference_mode():
        got = w.model._cross_attend(tp, w.t(x).to(dt), w.t(enc).to(dt))
    want = w.jmodel._cross_attend(jp, jnp.asarray(x).astype(dtype),
                                  jnp.asarray(enc).astype(dtype))
    assert _err(got, want) < (1e-4 if dtype == "float32" else 0.1)


class _Calls:
    """Counts the calls of the two attention wrappers (on the CPU they
    take the plain versions, which count no launch)."""

    def __init__(self, monkeypatch):
        self.n = {"flash_attention": 0, "decode_attention": 0}
        for name in self.n:
            fn = getattr(ops, name)
            monkeypatch.setattr(ops, name, self._counting(name, fn))

    def _counting(self, name, fn):
        def call(*args, **kwargs):
            self.n[name] += 1
            return fn(*args, **kwargs)
        return call


def test_kernel_calls_per_prefill_and_decode_step(whisper, monkeypatch):
    """A prefill calls K1 once per encoder layer and twice per decoder
    layer (causal self-attention, cross-attention), a decode step K2
    twice per decoder layer (the self cache, the cross K/V) and K1 never:
    on the card, 12 + 12 + 12 K1 and 24 K2 launches for whisper-small."""
    w = whisper("float32")
    calls = _Calls(monkeypatch)
    cfg = w.cfg
    with torch.inference_mode():
        cache = w.model.init_cache(B, MAX_LEN)
        w.model.prefill(w.params, w.t(w.tokens[:, :P]), cache,
                        w.t(w.frames))
        assert calls.n == {"flash_attention": cfg.encoder_layers
                           + 2 * cfg.num_layers, "decode_attention": 0}
        w.model.decode_step(w.params, w.t(w.tokens[:, P: P + 1]), cache, P)
    assert calls.n["decode_attention"] == 2 * cfg.num_layers
    assert calls.n["flash_attention"] == cfg.encoder_layers \
        + 2 * cfg.num_layers


@pytest.mark.parametrize("dtype", DTYPES)
def test_device_position_equals_int_position(dtype, whisper):
    """Decode steps at a 0-d int64 position (the captured graph's,
    advanced in place) give the logits and caches of the same steps at
    Python ints, bitwise."""
    w = whisper(dtype)
    want, want_cache = w.torch_steps()
    got, got_cache = w.torch_steps(pos=torch.tensor(P))
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    for key in ("k", "v"):
        assert torch.equal(got_cache["self"][key], want_cache["self"][key])
    assert torch.equal(got_cache["enc_out"], want_cache["enc_out"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_static_decode_steps_equal_the_model_loop(dtype, whisper):
    """The serving layer's static decode (the CPU's eager form of the
    captured step) with the frames: the prefill writes the encoder's
    output into the static cache's own leaf, and every step's logits and
    the generated tokens equal the model's own loop at int positions."""
    w = whisper(dtype)
    prompts = w.t(w.tokens[:, :P])
    frames = w.t(w.frames)
    with torch.inference_mode():
        slot = StaticDecode(w.model, w.params, B, MAX_LEN)
        enc_leaf = slot.cache["enc_out"]
        slot.prefill(prompts, frames)
        assert slot.cache["enc_out"] is enc_leaf
        assert torch.equal(enc_leaf, w.model.encode(w.params, frames))
        steps = [slot.step().clone() for _ in range(STEPS)]
        cache = w.model.init_cache(B, MAX_LEN)
        w.model.prefill(w.params, prompts, cache, frames)
        for i in range(STEPS):
            logits, _ = w.model.decode_step(
                w.params, slot.tokens[:, P + i: P + i + 1], cache, P + i)
            assert torch.equal(logits, steps[i]), i
        graphs = DecodeGraphs(w.model, w.params)
        tokens, _ = graphs.generate(prompts, STEPS + 1, MAX_LEN,
                                    extra_embeds=frames)
    assert torch.equal(tokens, slot.tokens[:, P:])
    assert (graphs.eager_steps, graphs.replays) == (STEPS, 0)


def test_prefill_without_frames_raises(whisper):
    w = whisper("float32")
    toks = w.t(w.tokens[:, :P])
    with torch.inference_mode():
        with pytest.raises(ValueError, match="encoder frames"):
            w.model.prefill(w.params, toks, w.model.init_cache(B, MAX_LEN))
        with pytest.raises(ValueError, match="encoder frames"):
            w.model.forward(w.params, toks)
        with pytest.raises(ValueError, match="do not fill"):
            w.model.prefill(w.params, toks, w.model.init_cache(B, MAX_LEN),
                            w.t(w.frames[:, :5]))


def test_run_stage_without_frames_raises(whisper):
    """The serving engine passes no frames to a prefill, as in the
    reference, whose run_stage fails on an audio bundle (ROADMAP H24)."""
    w = whisper("float32")
    bundle = ModelBundle.create("asr", w.cfg, device="cpu", params=w.params)
    engine = ServingEngine({"asr": bundle}, n_devices=1, gen_len=2,
                           prompt_len=P, device="cpu")
    stage = Stage("transcribe", "asr", base_cost={-1: 0.01})
    wf = Workflow(wid="asr", num_queries=B, stages={"transcribe": stage})
    with pytest.raises(ValueError, match="passes no encoder frames"):
        engine.run_stage(wf, stage, Placement("asr", "transcribe", (0,), (B,)),
                         torch.from_numpy(w.tokens[:, :P]))
    assert not engine.log
