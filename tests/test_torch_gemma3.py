"""gemma3's local (sliding-window) and global layers in the port against
the JAX package, on SMOKE gemma3 (7 layers L L G L L G L, window 8, head
dim 16), from converted parameters: the layer pattern and caches, the
ring cache's slot and length, the ring against the reference's rolling
cache, and decode steps in every regime of prompt, window and
``max_len`` (ROADMAP H23 where the reference departs from its own
forward); and the port's per-arch config modules against the
reference's.  Inputs come from numpy with a seed, as in
``tests/test_torch_models.py``, whose helpers this file shares.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.models import attention as attn
from repro_torch.models import layers
from test_torch_models import B, max_err, pair, softmax_err  # noqa: F401

# ---------------------------------------------------------------------------
# gemma3: local (sliding-window) and global layers
# ---------------------------------------------------------------------------

GEMMA = "gemma3-4b"


def test_gemma3_layer_pattern_stacks_and_caches(pair):
    """SMOKE gemma3: 7 layers L L G L L G L, ``local_blocks`` of 5 and
    ``global_blocks`` of 2 as in the JAX tree, local caches of
    ``min(window, max_len)`` rows and global ones of ``max_len``."""
    p = pair(GEMMA, "float32")
    assert p.model.layer_kinds() == p.jmodel.layer_kinds() == \
        list("LLGLLGL")
    assert (p.model.n_global, p.model.n_local) == (2, 5)
    assert p.params["local_blocks"]["attn"]["wq"].shape[0] == 5
    assert p.params["global_blocks"]["attn"]["wq"].shape[0] == 2
    for max_len, local_rows in ((5, 5), (8, 8), (20, 8)):
        cache = p.model.init_cache(B, max_len)
        jcache = p.jmodel.init_cache(B, max_len)
        assert set(cache) == set(jcache) == {"local", "global"}
        for kind, rows in (("local", local_rows), ("global", max_len)):
            assert cache[kind]["k"].shape[2] == rows
            assert tuple(cache[kind]["v"].shape) == \
                tuple(jcache[kind]["v"].shape)


PORTED_CONFIG_MODULES = sorted(
    m.stem for m in (Path(layers.__file__).parents[1] / "configs").glob(
        "*.py") if m.stem not in ("__init__", "archs", "base"))


@pytest.mark.parametrize("module", PORTED_CONFIG_MODULES)
def test_config_modules_copy_the_reference(module):
    """Each of the port's per-arch config modules (``gemma3_4b`` among
    them) gives the JAX module's ``CONFIG`` and ``SMOKE_CONFIG``, field for
    field."""
    import importlib
    ours = importlib.import_module(f"repro_torch.configs.{module}")
    theirs = importlib.import_module(f"repro.configs.{module}")
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert dataclasses.asdict(getattr(ours, name)) == \
            dataclasses.asdict(getattr(theirs, name)), name


@pytest.mark.parametrize("ring", [False, True])
def test_decode_index_int_and_device_forms(ring):
    """Row ``pos`` and length ``pos + 1`` in a linear cache; slot ``pos mod
    rows`` and length ``min(pos + 1, rows)`` in a ring; the device form
    (from a 0-d int64 position) holds the same values as the int form."""
    rows = 8
    for pos in range(0, 3 * rows if ring else rows):
        want = attn.decode_index(pos, rows, ring=ring)
        assert want.row == (pos % rows if ring else pos)
        assert want.length == (min(pos + 1, rows) if ring else pos + 1)
        got = attn.decode_index(torch.tensor(pos), rows, ring=ring)
        assert got.row.dtype == torch.int64 and got.row.shape == (1,)
        assert got.length.dtype == torch.int32 and got.length.dim() == 0
        assert int(got.row) == want.row and int(got.length) == want.length
    if not ring:
        with pytest.raises(NotImplementedError):
            attn.decode_index(rows, rows)


def test_gqa_attend_ring_holds_the_reference_rolling_rows(pair):
    """One local layer: a prefill of 12 into a ring of 8 keeps positions
    4-11, each in slot ``p mod 8``; a decode step writes position 12 into
    slot 4.  Rotated by the next position, the ring equals the
    reference's rolling cache (shifted left, newest last) after the
    prefill and after each of three steps, and the outputs agree."""
    p = pair(GEMMA, "float32")
    cfg, jcfg = p.cfg, p.jcfg
    w = cfg.sliding_window
    jp = jax.tree.map(lambda a: a[0], p.jparams["local_blocks"]["attn"])
    tp = {k: v[0] for k, v in p.params["local_blocks"]["attn"].items()}
    rng = np.random.default_rng(23)
    plen = 12
    x = rng.standard_normal((B, plen + 3, cfg.d_model), dtype=np.float32)
    shape = (B, w, cfg.num_kv_heads, cfg.resolved_head_dim)
    jcache = (jnp.zeros(shape), jnp.zeros(shape))
    tcache = (torch.zeros(shape), torch.zeros(shape))
    for start, n in ((0, plen), (plen, 1), (plen + 1, 1), (plen + 2, 1)):
        xs = x[:, start: start + n]
        jpos = jnp.arange(start, start + n)[None, :]
        jout, jcache = jax_attn.gqa_attend(
            jp, jcfg, jnp.asarray(xs), jpos, window=w, cache=jcache,
            cache_len=start)
        tout, _ = attn.gqa_attend(
            tp, cfg, torch.from_numpy(xs),
            torch.arange(start, start + n)[None, :], window=w,
            cache=tcache, cache_len=start)
        assert max_err(tout, jout) < 1e-5, start
        shift = (start + n) % w
        for got, want in zip(tcache, jcache):
            assert max_err(torch.roll(got, -shift, dims=1), want) < 1e-5


def _gemma_steps(p, plen, max_len, steps, device_pos=False):
    """Both packages: forward over the prompt and ``steps`` more tokens,
    prefill of ``plen`` tokens into caches of ``max_len``, then ``steps``
    decode steps teacher-forced with the same tokens (the port's at a
    device position when ``device_pos``)."""
    toks = p.tokens[:, : plen + steps]
    jfull = p.jmodel.forward(p.jparams, jnp.asarray(toks))
    jcache = p.jmodel.init_cache(B, max_len)
    jpre, jcache = p.jmodel.prefill(p.jparams, jnp.asarray(toks[:, :plen]),
                                    jcache)
    jdec = []
    for i in range(steps):
        lg, jcache = p.jmodel.decode_step(
            p.jparams, jnp.asarray(toks[:, plen + i: plen + i + 1]), jcache,
            jnp.int32(plen + i))
        jdec.append(lg[:, 0])
    with torch.inference_mode():
        tt = torch.from_numpy(toks)
        tfull = p.model.forward(p.params, tt)
        cache = p.model.init_cache(B, max_len)
        tpre, _ = p.model.prefill(p.params, tt[:, :plen], cache)
        pos = torch.tensor(plen) if device_pos else plen
        tdec = []
        for i in range(steps):
            lg, _ = p.model.decode_step(
                p.params, tt[:, plen + i: plen + i + 1], cache, pos)
            tdec.append(lg[:, 0])
            pos = pos + 1
    return (jfull, jpre, jdec), (tfull, tpre, tdec)


# (prompt, max_len, decode steps) with SMOKE's window of 8: max_len below
# the window (local caches of max_len rows, never full); a prompt of one
# window, then the rolling cache; a prompt that wraps the ring
SELF_CONSISTENT = [(4, 7, 3), (8, 16, 5), (12, 20, 5)]


@pytest.mark.parametrize("plen,max_len,steps", SELF_CONSISTENT)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_decode_matches_jax_where_the_reference_agrees_with_itself(
        plen, max_len, steps, dtype, pair):
    """Where the reference's own decode steps agree with its forward
    (``max_len`` below the window, or a prompt at least one window long),
    the port's prefill and every decode step match the reference's: 1e-4
    on the logits in float32, the softmax bars in bf16 (H1)."""
    p = pair(GEMMA, dtype)
    assert max_len < p.cfg.sliding_window or plen >= p.cfg.sliding_window
    (jfull, jpre, jdec), (tfull, tpre, tdec) = _gemma_steps(
        p, plen, max_len, steps, device_pos=True)
    if dtype == "float32":
        assert max_err(tfull, jfull) < 1e-4
        assert max_err(tpre, jpre) < 1e-4
        for i, (a, b) in enumerate(zip(tdec, jdec)):
            assert max_err(a, b) < 1e-4, i
            assert max_err(a, tfull[:, plen + i]) < 1e-4, i
    else:
        assert softmax_err(tfull, jfull) < 0.03
        assert softmax_err(tpre, jpre) < 0.03
        for i, (a, b) in enumerate(zip(tdec, jdec)):
            assert softmax_err(a, b) < 0.05, i


def test_gemma3_short_prompt_decode_matches_forward_where_the_reference_departs(
        pair):
    """ROADMAP H23: a prompt shorter than a window that fits ``max_len``
    (prompt 4, window 8, ``max_len`` 16).  The reference's prefill writes
    rows 0-3 of its 8-row rolling cache, and its decode then attends the
    last slots, which hold zeros: its decode logits depart from its own
    forward over the same tokens.  The port's ring holds the prompt's
    rows, so its decode steps match the forward (the reference's and its
    own) to 1e-4 in float32."""
    p = pair(GEMMA, "float32")
    plen, max_len, steps = 4, 16, 3
    assert plen < p.cfg.sliding_window <= max_len
    (jfull, jpre, jdec), (tfull, tpre, tdec) = _gemma_steps(
        p, plen, max_len, steps)
    assert max_err(tpre, jpre) < 1e-4
    departs = [max_err(b, jfull[:, plen + i]) for i, b in enumerate(jdec)]
    assert min(departs) > 0.5, departs
    for i, a in enumerate(tdec):
        assert max_err(a, jfull[:, plen + i]) < 1e-4, i
        assert max_err(a, tfull[:, plen + i]) < 1e-4, i
