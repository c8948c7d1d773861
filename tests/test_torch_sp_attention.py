"""K1's ``q_offset`` and sequence-parallel prefill on the CPU: the port's
plain K1 (``flash_attention_ref``, which ``ops.flash_attention`` takes for
CPU tensors) and ``models.attention.flash_attention_sp`` against the JAX
package's XLA twin ``repro.models.attention.flash_attention(q_offset=...)``
and its ``flash_attention_sp``, forward and gradient, float32 at 1e-5
(two frameworks summing the same float32 products in another order).

The reference's ``flash_attention_sp`` is called with an explicit
``n_sp``: with no axis environment its ``shard_activation`` is a no-op,
so the lanes are a ``vmap`` over query chunks, each at its own offset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import attention as attn

TOL = 1e-5


def _inputs(seed, b, sq, sk, h, kv, d, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, kv, d), dtype=np.float32),
            rng.standard_normal((b, sk, kv, dv), dtype=np.float32),
            rng.standard_normal((b, sq, h, dv), dtype=np.float32))


def _torch_value_and_grads(fn, q, k, v, dout):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _jax_value_and_grads(fn, q, k, v, dout):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _close(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# (b, sq, sk, h, kv, d, dv): GQA, Sq < Sk, and deepseek's Dv != D
SHAPES = [(2, 24, 56, 4, 2, 16, 16), (1, 16, 48, 2, 2, 24, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20),
                                           (False, 0), (False, 40)])
def test_plain_k1_q_offset_matches_xla_twin(shape, causal, window):
    """Query row i at q_offset + i (0, 7 and 32 over Sk > Sq keys): the
    port's plain K1 against the reference's XLA ``flash_attention``,
    output and ``jax.vjp`` (one jitted vjp, the offset traced)."""
    b, sq, sk, h, kv, d, dv = shape
    q, k, v, dout = _inputs(3, b, sq, sk, h, kv, d, dv)

    @jax.jit
    def ref_vjp(q, k, v, dout, off):
        out, vjp = jax.vjp(lambda *a: jax_attn.flash_attention(
            *a, causal=causal, window=window, q_offset=off, q_chunk=8,
            kv_chunk=8), q, k, v)
        return out, vjp(dout)

    for q_offset in (0, 7, 32):
        mine, mine_g = _torch_value_and_grads(
            lambda *a: flash_attention_ref(*a, causal=causal, window=window,
                                           q_offset=q_offset), q, k, v, dout)
        want, want_g = ref_vjp(q, k, v, dout, jnp.int32(q_offset))
        assert _close(mine, want) < TOL
        for g, w in zip(mine_g, want_g):
            assert _close(g, w) < TOL


@pytest.mark.parametrize("q_offset", [0, 5, 24])
def test_wrapper_q_offset_on_cpu(q_offset):
    """``ops.flash_attention`` with a q_offset takes the plain version for
    CPU tensors, with and without grad (a q_offset under grad goes
    through autograd of the plain forward: K1b takes no offset), and
    counts no launch."""
    q, k, v, dout = _inputs(5, 1, 16, 40, 4, 2, 16, 16)
    before = ops.flash_attention.launches
    with torch.no_grad():
        plain = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    window=12, q_offset=q_offset)
    got, grads = _torch_value_and_grads(
        lambda *a: ops.flash_attention(*a, window=12, q_offset=q_offset),
        q, k, v, dout)
    want, want_g = _torch_value_and_grads(
        lambda *a: flash_attention_ref(*a, window=12, q_offset=q_offset),
        q, k, v, dout)
    assert ops.flash_attention.launches == before
    assert np.array_equal(plain.numpy(), want)
    assert _close(got, want) < TOL
    for g, w in zip(grads, want_g):
        assert _close(g, w) < TOL
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=-1)


@pytest.mark.parametrize("n_sp", [1, 2, 4])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12),
                                           (False, 0)])
def test_flash_attention_sp_matches_reference(n_sp, causal, window):
    """``flash_attention_sp`` against the reference's at the same
    ``n_sp``: output and gradient, float32 at 1e-5."""
    q, k, v, dout = _inputs(11, 2, 32, 32, 4, 2, 16, 16)
    mine, mine_g = _torch_value_and_grads(
        lambda *a: attn.flash_attention_sp(*a, causal=causal, window=window,
                                           n_sp=n_sp), q, k, v, dout)
    want, want_g = _jax_value_and_grads(
        lambda *a: jax_attn.flash_attention_sp(*a, causal=causal,
                                               window=window, n_sp=n_sp),
        q, k, v, dout)
    assert _close(mine, want) < TOL
    for g, w in zip(mine_g, want_g):
        assert _close(g, w) < TOL


def test_flash_attention_sp_value_dim_and_lanes():
    """The lanes concatenate to [B, Sq, H, Dv] (deepseek's Dv != D), and
    equal one call over the whole sequence; a length the lanes do not
    divide, and n_sp 1, make one call."""
    q, k, v, _ = _inputs(13, 1, 24, 24, 2, 2, 24, 16)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    whole = ops.flash_attention(qt, kt, vt)
    lanes = attn.flash_attention_sp(qt, kt, vt, n_sp=3)
    assert lanes.shape == (1, 24, 2, 16)
    assert _close(lanes.numpy(), whole.numpy()) < TOL
    for n in (1, 5):
        assert torch.equal(attn.flash_attention_sp(qt, kt, vt, n_sp=n),
                           whole)


def test_seq_parallel_degree_without_mesh():
    """With no axis environment there is no sequence parallelism, so
    ``gqa_attend`` makes one K1 call, as on one card."""
    assert attn.seq_parallel_degree(20) == 1
    assert jax_attn.seq_parallel_degree(20) == 1
