"""The port's spec layer, its DeviceMesh placements and the kernel
wrappers' meta-device paths, on the CPU (the dry run itself:
``test_torch_dryrun.py``).

Held against the JAX package where it has a counterpart:
``filter_spec`` and each leaf's bytes on one device, for every leaf of
every registry config's train state, served parameters and cache, on the
reference's production meshes, here stand-ins with the two attributes the
reference's ``filter_spec`` reads (``axis_names`` and ``shape``); the
abstract trees leaf by leaf; ``input_specs``.  The reference's dry-run
module is not imported: it sets ``XLA_FLAGS`` for every JAX that starts
after it in the process.

A torch ``DeviceMesh`` needs a default process group: one of PyTorch's
fake backend, made and destroyed by the module-scoped fixture ``mesh``
(the tests run several files in one worker process).
"""
import math
import types

import jax
import pytest
import torch

from repro.configs.archs import ARCHS as JAX_ARCHS
from repro.launch import mesh as jax_mesh
from repro.launch import steps as jax_steps
from repro.models.families import build_model as jax_build_model
from repro.models.layers import DP as JAX_DP
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.configs.base import SHAPES, ShapeConfig, cells_for
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers
from repro_torch.models.families import build_model
from repro_torch.models.layers import DP
from repro_torch.models.transformer import _shard
from repro_torch.training.tree import tree_paths

DUCK_MESHES = {
    "single": types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": 16, "model": 16}),
    "multi": types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                   shape={"pod": 2, "data": 16,
                                          "model": 16}),
}


@pytest.fixture(scope="module")
def mesh():
    """A (1, 2) DeviceMesh over (data, model) on a fake process group of
    two ranks, destroyed after the module."""
    with mesh_mod.fake_world(2):
        yield mesh_mod.make_test_mesh((1, 2), ("data", "model"))


# ---------------------------------------------------------------------------
# the reference's trees, with paths and specs
# ---------------------------------------------------------------------------


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def jax_leaves(tree) -> dict:
    """path -> leaf of a JAX tree (dict keys sorted, as ``tree_paths``)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key(k) for k in path): leaf for path, leaf in flat}


def _walk(tree, path: str):
    for k in path.split("/"):
        tree = getattr(tree, k) if hasattr(tree, "_fields") else tree[k]
    return tree


def _jax_ref_train(cfg):
    aparams, astate, specs, sspecs = jax_steps.abstract_train_state(cfg)
    return {"params": aparams, "opt": astate}, {"params": specs,
                                                "opt": sspecs}


def _port_train(cfg):
    aparams, astate, specs, sspecs = steps.abstract_train_state(cfg)
    return {"params": aparams, "opt": astate}, {"params": specs,
                                                "opt": sspecs}


def _norm(entries) -> tuple:
    """Spec entries as a PartitionSpec holds them: a one-axis tuple is
    that axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _ref_device_bytes(m, shape, entries, itemsize) -> int:
    """Bytes of one device's shard under the reference's filtered spec."""
    n = 1
    for dim, ax in zip(shape, tuple(entries) + (None,) * len(shape)):
        n *= dim // jax_mesh._axis_size(m, ax)
    return n * itemsize


def _trees(arch):
    """(name, JAX tree, JAX specs, port tree, port specs) of the train
    state, the served parameters and the decode_32k cache."""
    jcfg, cfg = JAX_ARCHS[arch], ARCHS[arch]
    jt, js = _jax_ref_train(jcfg)
    pt, ps = _port_train(cfg)
    jsp, jss = jax_steps.abstract_serve_params(jcfg)
    psp, pss = steps.abstract_serve_params(cfg)
    shape = SHAPES["decode_32k"]
    jm, pm = jax_build_model(jcfg), build_model(cfg, "meta")
    from repro.models.transformer import cache_specs as jax_cache_specs
    from repro_torch.models.transformer import cache_specs
    jc = jm.init_cache(shape.global_batch, shape.seq_len, abstract=True)
    jcs = jax_cache_specs(jm.cache_defs(shape.global_batch, shape.seq_len))
    pc = pm.init_cache(shape.global_batch, shape.seq_len, abstract=True)
    pcs = cache_specs(pm.cache_defs(shape.global_batch, shape.seq_len))
    return [("train", jt, js, pt, ps), ("serve", jsp, jss, psp, pss),
            ("cache", jc, jcs, pc, pcs)]


# ---------------------------------------------------------------------------
# trees and specs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_trees_match_reference(arch):
    """Every leaf of the train state (float32 masters, bf16 moments, an
    int32 step), the served parameters and the cache: the same paths,
    shapes and dtypes as the reference's abstract trees (the cache's
    layouts have the same shapes; the ring's slot order differs, ROADMAP
    H23), and the same specs."""
    for name, jt, js, pt, ps in _trees(arch):
        jl, pl = jax_leaves(jt), dict(tree_paths(pt))
        assert sorted(jl) == sorted(pl), name
        for path, leaf in jl.items():
            mine = pl[path]
            assert mine.device.type == "meta"
            assert tuple(mine.shape) == tuple(leaf.shape), (name, path)
            assert str(mine.dtype)[6:] == str(leaf.dtype), (name, path)
            assert tuple(_walk(ps, path)) == tuple(_walk(js, path)), \
                (name, path)


@pytest.mark.parametrize("which", sorted(DUCK_MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_filter_spec_and_device_bytes_match_reference(arch, which):
    """On the (16, 16) and (2, 16, 16) meshes, each leaf's filtered spec
    equals the reference's ``filter_spec`` over the reference's own
    trees, and its bytes on one device under the port's placements equal
    the reference's shard; so do the trees' totals."""
    m = DUCK_MESHES[which]
    for name, jt, js, pt, ps in _trees(arch):
        pl = dict(tree_paths(pt))
        total_ref = total_mine = 0
        for path, leaf in jax_leaves(jt).items():
            shape = tuple(leaf.shape)
            want = tuple(jax_mesh.filter_spec(m, shape,
                                              tuple(_walk(js, path))))
            got = mesh_mod.filter_spec(m, shape, tuple(_walk(ps, path)))
            assert _norm(got) == _norm(want), (name, path)
            placements = layers.spec_placements(m, got)
            mine = math.prod(mesh_mod.local_shape(m, shape, placements)) \
                * pl[path].element_size()
            ref = _ref_device_bytes(m, shape, want, leaf.dtype.itemsize)
            assert mine == ref, (name, path)
            total_ref, total_mine = total_ref + ref, total_mine + mine
        shardings = mesh_mod.shardings_for(m, pt, ps)
        assert mesh_mod.device_bytes(m, pt, shardings) == total_mine \
            == total_ref


def test_multi_pod_deepseek_masters():
    """deepseek-v2-236b's float32 masters (33 leaves) on one device of
    the multi-pod mesh."""
    m = DUCK_MESHES["multi"]
    params, _, specs, _ = steps.abstract_train_state(ARCHS["deepseek-v2-236b"])
    assert len(tree_paths(params)) == 33
    got = mesh_mod.device_bytes(m, params,
                                mesh_mod.shardings_for(m, params, specs))
    assert abs(got / 1e9 - 4.617) < 1e-3


@pytest.mark.parametrize("spec,shape,want", [
    ((DP, None), (64, 8), (("pod", "data"), None)),
    ((DP, "model"), (16, 24), ("data", None)),       # partial composite
    ((DP,), (2,), ("pod",)),
    (("model", "data"), (40, 32), (None, "data")),   # 40 experts on 16
    ((None, "model", None), (4, 32, 3, 5), (None, "model", None, None)),
])
def test_filter_spec_cases(spec, shape, want):
    """The divisibility fallback and the partial composites, as the
    reference's."""
    m = DUCK_MESHES["multi"]
    assert _norm(mesh_mod.filter_spec(m, shape, spec)) == _norm(want)
    jspec = tuple(JAX_DP if s == DP else s for s in spec)
    assert _norm(jax_mesh.filter_spec(m, shape, jspec)) == _norm(want)


def test_spec_placements_in_mesh_order():
    """A dim on (pod, data) is Shard on both mesh dims, in mesh order;
    an order torch cannot express, an axis used twice or one not on the
    mesh raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = DUCK_MESHES["multi"]
    assert layers.spec_placements(m, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert layers.spec_placements(m, (None,)) == (Replicate(),) * 3
    for bad in ((("data", "pod"),), ("data", "data"), ("expert",)):
        with pytest.raises(ValueError, match="cannot be placed"):
            layers.spec_placements(m, bad)


@pytest.mark.parametrize("arch,shape", [
    cell for arch in ("qwen3-1.7b", "whisper-small", "llava-next-mistral-7b",
                      "gemma3-4b") for cell in cells_for(ARCHS[arch])])
def test_input_specs_shapes(arch, shape):
    """Every input of a cell has the reference's shape (tokens and labels
    int64, as the port's data stream gives them)."""
    want = jax_leaves(jax_steps.input_specs(JAX_ARCHS[arch], shape))
    got = dict(tree_paths(steps.input_specs(ARCHS[arch], shape)))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        if path in ("tokens", "labels", "token", "pos"):
            assert got[path].dtype == torch.int64
        else:
            assert str(got[path].dtype)[6:] == str(leaf.dtype), path


def test_shapeconfig_input_specs_and_token_budget():
    """``input_specs`` takes a ShapeConfig too, as the reference's."""
    sh = ShapeConfig("tiny", 24, 3, "train")
    got = steps.input_specs(SMOKE["qwen3-1.7b"], sh)
    assert tuple(got["tokens"].shape) == (3, 24)
    assert steps._token_budget(SMOKE["qwen3-1.7b"], sh) == 24


# ---------------------------------------------------------------------------
# the spec layer on a DeviceMesh
# ---------------------------------------------------------------------------


def test_shard_is_identity_without_axis_env():
    """With no axis environment ``shard_activation`` and ``_shard`` give
    ``x`` itself; with one, a plain tensor is returned as it is."""
    x = torch.zeros(4, 6)
    assert layers.get_axis_env() is None
    assert layers.shard_activation(x, DP, None) is x
    assert _shard(x, DP, None) is x
    assert layers.resolve_spec((DP, None)) is None


def test_shard_activation_redistributes_dtensor(mesh):
    """On a DTensor, ``shard_activation`` redistributes to the placements
    its spec resolves to (an axis dropped where it does not divide the
    dim), ``_shard`` likewise without the divisibility check."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = DTensor.from_local(torch.zeros(4, 3, device="meta"), mesh,
                           [Replicate(), Replicate()], run_check=False)
    with mesh_mod.use_mesh(mesh):
        assert layers.resolve_spec((DP, "model")) == (("data",), "model")
        assert layers.shard_activation(torch.zeros(2), DP) is not None
        y = layers.shard_activation(x, DP, "model")    # 3 % 2: dropped
        assert tuple(y.placements) == (Replicate(), Replicate())
        y = layers.shard_activation(x, "model", None)
        assert tuple(y.placements) == (Replicate(), Shard(0))
        assert y.to_local().shape == (2, 3)
        assert _shard(y, "model", None) is y
    assert layers.get_axis_env() is None


def test_device_mesh_matches_duck_mesh(mesh):
    """A torch DeviceMesh and a stand-in of the same shape give the same
    filtered specs and bytes; DTensor's own local shard agrees."""
    from torch.distributed.tensor import DTensor
    duck = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 2})
    params, _, specs, _ = steps.abstract_train_state(SMOKE["qwen3-1.7b"])
    a = mesh_mod.shardings_for(mesh, params, specs)
    b = mesh_mod.shardings_for(duck, params, specs)
    assert a == b
    assert mesh_mod.device_bytes(mesh, params, a) == \
        mesh_mod.device_bytes(duck, params, b)
    leaf, pl = params["embed"], a["embed"]
    local = mesh_mod.local_shape(mesh, leaf.shape, pl)
    d = DTensor.from_local(torch.empty(local, device="meta"), mesh, pl,
                           run_check=False, shape=leaf.shape,
                           stride=leaf.stride())
    assert tuple(d.shape) == tuple(leaf.shape)
    assert tuple(d.to_local().shape) == local


def test_seq_parallel_degree_on_a_mesh(mesh):
    """A model axis that does not divide the heads gives its size."""
    from repro_torch.models.attention import seq_parallel_degree
    with mesh_mod.use_mesh(mesh):
        assert seq_parallel_degree(3) == 2
        assert seq_parallel_degree(4) == 1
    assert seq_parallel_degree(3) == 1


# ---------------------------------------------------------------------------
# the wrappers on meta tensors
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def test_wrappers_on_meta_allocate_and_launch_nothing():
    """Every kernel wrapper on meta tensors runs its checks and gives its
    outputs' shapes and dtypes, through its autograd function where grad
    is needed, and counts no launch."""
    ops.reset_launch_counts()
    q, k = _meta(2, 64, 8, 128, grad=True), _meta(2, 64, 4, 128, grad=True)
    out = ops.flash_attention(q, k, k)
    out.float().sum().backward()
    assert out.shape == (2, 64, 8, 128) and q.grad.shape == q.shape
    assert ops.flash_attention(q.detach(), k.detach(), k.detach(),
                               q_offset=64).device.type == "meta"
    with pytest.raises(NotImplementedError, match="H2"):
        ops.flash_attention(q, k, k, q_offset=64)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(_meta(1, 8, 2, 24), _meta(1, 8, 2, 24),
                            _meta(1, 8, 2, 24))
    dec = ops.decode_attention(_meta(2, 1, 8, 128), _meta(2, 100, 4, 128),
                               _meta(2, 100, 4, 128), 50)
    assert dec.shape == (2, 1, 8, 128)
    x, w = _meta(2, 4, 16, 32, grad=True), _meta(4, 32, 48, grad=True)
    y = ops.moe_gemm(x, w)
    y.float().sum().backward()
    assert y.shape == (2, 4, 16, 48) and w.grad.shape == w.shape
    xh = _meta(1, 128, 4, 64, grad=True)
    bc = _meta(1, 128, 64, grad=True)
    dt = _meta(1, 128, 4, dtype=torch.float32, grad=True)
    a_log = _meta(4, dtype=torch.float32, grad=True)
    y, fin = ops.mamba2_scan(xh, bc, bc, dt, a_log, chunk=64,
                             out_dtype=torch.float32)
    y.sum().backward()
    assert y.dtype == torch.float32 and xh.grad.shape == xh.shape
    r = _meta(1, 64, 2, 64, grad=True)
    wd = _meta(1, 64, 2, 64, dtype=torch.float32, grad=True)
    bonus = _meta(2, 64, dtype=torch.float32, grad=True)
    out, fin = ops.rwkv6_scan(r, r, r, wd, bonus, chunk=32)
    out.float().sum().backward()
    assert fin.shape == (1, 2, 64, 64) and bonus.grad.shape == bonus.shape
    assert all(n == 0 for n in ops.counts().values())
