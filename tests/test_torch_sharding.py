"""The port's sharding rules, parameter and input structs, ECC structs and
pod meshes against the reference's (src/repro/distributed/sharding.py,
src/repro/configs/shapes.py, src/repro/launch/{mesh,ecc_struct}.py).

Every spec is compared as a tuple with the reference's ``PartitionSpec``,
leaf by leaf, on abstract meshes from one device to the (2, 16, 16) pod, for
the ten LM archs (the eleventh config, paper-nn, is the Fig. 3 MLP and has
no LM parameter tree); every struct's shapes and dtypes are compared on the
meta device, where nothing is allocated."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.distributed import sharding as jshd
from repro.kernels.ops import EccWeight as JEccWeight
from repro.launch import ecc_struct as jecc
from repro.launch.mesh import compat_abstract_mesh
from repro.models import lm as jlm
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes as tshapes
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels.ops import EccWeight
from repro_torch.launch import ecc_struct as tecc
from repro_torch.launch.mesh import abstract_mesh, make_host_mesh, make_production_mesh
from repro_torch.models import base as tbase
from repro_torch.models import lm as tlm

LM_ARCHS = [a for a in ARCHS if a != "paper-nn"]
MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
CACHE_ARCHS = ["qwen3-0.6b", "mixtral-8x22b", "rwkv6-3b", "jamba-1.5-large-398b"]
# (batch, max_len): the reference's flash-decoding case, the decode and
# long-context cells, and odd sizes that fall back
CACHE_SIZES = [(128, 1024), (128, 32768), (1, 524288), (3, 100), (2, 4096)]
BATCHES = [1, 2, 3, 4, 8, 16, 32, 128, 256, 512]


def _meshes(shape, axes):
    return compat_abstract_mesh(shape, axes), abstract_mesh(shape, axes)


def _jflat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


def _jdt(x) -> str:
    return str(np.dtype(x.dtype)) if str(x.dtype) != "bfloat16" else "bfloat16"


def _tdt(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _structs_equal(ref_tree, port_tree, plane_dtypes=None):
    ref, port = _jflat(ref_tree), tbase.flatten(port_tree)
    assert [k for k, _ in ref] == [k for k, _ in port]
    for (k, r), (_, t) in zip(ref, port):
        assert t.device.type == "meta", k
        assert tuple(r.shape) == tuple(t.shape), k
        assert (plane_dtypes or {}).get(_jdt(r), _jdt(r)) == _tdt(t), k


# -- the reference's own rule tests on the port ---------------------------------
def test_spec_rules_basic():
    m = abstract_mesh((1, 1), ("data", "model"))
    assert tshd.spec_for(("embed", "heads"), (64, 64), m, False) == (None, "model")
    assert tshd.spec_for(("vocab", "embed"), (128, 64), m, True) == ("model", "data")
    assert tshd.spec_for(("experts", "embed", "ffn"), (4, 8, 16), m, False) == (
        "model", None, None)


def test_spec_divisibility_fallback():
    m = abstract_mesh((1, 2), ("data", "model"))
    assert tshd.spec_for(("experts", "ffn"), (3, 8), m, False) == (None, "model")


def test_cache_shardings_flash_decoding():
    cfg = get_config("qwen3-0.6b")
    m = abstract_mesh((1, 1), ("data", "model"))
    shards = tshd.cache_shardings(cfg, m, tshapes.cache_struct(cfg, 128, 1024))
    assert shards["p0"]["k"].spec == (None, "data", "model", None, None)


def test_production_meshes_are_the_pods():
    for multi_pod in (False, True):
        m = make_production_mesh(multi_pod=multi_pod)
        ref_shape = (2, 16, 16) if multi_pod else (16, 16)
        assert m.sizes == ref_shape and m.devices is None
        assert m.axis_names == (("pod", "data", "model") if multi_pod else ("data", "model"))


def test_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_host_mesh(device="cpu")


# -- structs -----------------------------------------------------------------------
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_struct_and_logical_axes_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    _structs_equal(jlm.param_struct(jcfg), tlm.param_struct(cfg))
    ref = _jflat(jlm.logical_axes(jcfg), is_leaf=lambda x: isinstance(x, tuple))
    port = tbase.flatten(tlm.logical_axes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    assert ref == port


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_specs_and_cache_struct_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert tshapes.supported_shapes(arch) == jshapes.supported_shapes(arch)
    assert tshapes.SHAPES == {k: tshapes.ShapeSpec(*v.__dict__.values())
                              for k, v in jshapes.SHAPES.items()}
    for name in tshapes.supported_shapes(arch):
        _structs_equal(jshapes.input_specs(jcfg, name), tshapes.input_specs(cfg, name))
    for b, s in CACHE_SIZES[:3]:
        _structs_equal(jshapes.cache_struct(jcfg, b, s), tshapes.cache_struct(cfg, b, s))


# -- the rules leaf by leaf ----------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    jm, tm = _meshes(*mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for fsdp in (False, True):
        ref = _jflat(jshd.param_shardings(jcfg, jm, fsdp))
        port = tbase.flatten(tshd.param_shardings(cfg, tm, fsdp),
                             is_leaf=lambda x: isinstance(x, tshd.NamedSharding))
        assert [(k, tuple(r.spec)) for k, r in ref] == [(k, tuple(t.spec)) for k, t in port]
        assert all(t.mesh is tm for _, t in port)
    ref = _jflat(jshd.param_shardings_fsdp_only(jcfg, jm))
    port = tbase.flatten(tshd.param_shardings_fsdp_only(cfg, tm),
                         is_leaf=lambda x: isinstance(x, tshd.NamedSharding))
    assert [(k, tuple(r.spec)) for k, r in ref] == [(k, tuple(t.spec)) for k, t in port]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_data_and_batch_shardings_equal_the_reference(mesh):
    jm, tm = _meshes(*mesh)
    for b in BATCHES:
        assert tuple(tshd.data_sharding(tm, b).spec) == tuple(jshd.data_sharding(jm, b).spec)
        assert (tuple(tshd.data_sharding_all_axes(tm, b).spec)
                == tuple(jshd.data_sharding_all_axes(jm, b).spec))
    for arch in ("qwen3-0.6b", "llama-3.2-vision-11b", "musicgen-medium"):
        ref = jshd.batch_shardings(jm, jshapes.input_specs(jget_config(arch), "train_4k"))
        port = tshd.batch_shardings(tm, tshapes.input_specs(get_config(arch), "train_4k"))
        assert {k: tuple(v.spec) for k, v in ref.items()} == {
            k: tuple(v.spec) for k, v in port.items()}
    assert tuple(tshd.replicated(tm).spec) == tuple(jshd.replicated(jm).spec) == ()


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_shardings_equal_the_reference(arch, mesh):
    jm, tm = _meshes(*mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for b, s in CACHE_SIZES:
        ref = _jflat(jshd.cache_shardings(jcfg, jm, jshapes.cache_struct(jcfg, b, s)))
        port = tbase.flatten(tshd.cache_shardings(cfg, tm, tshapes.cache_struct(cfg, b, s)),
                             is_leaf=lambda x: isinstance(x, tshd.NamedSharding))
        assert [(k, tuple(r.spec)) for k, r in ref] == [(k, tuple(t.spec)) for k, t in port]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_ecc_param_struct_and_shardings_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    is_j = lambda x: isinstance(x, JEccWeight)  # noqa: E731
    ref = _jflat(jecc.ecc_param_struct(jcfg), is_leaf=is_j)
    port = tbase.flatten(tecc.ecc_param_struct(cfg))
    assert [k for k, _ in ref] == [k for k, _ in port]
    n_ecc = 0
    for (k, r), (_, t) in zip(ref, port):
        assert isinstance(t, EccWeight) == isinstance(r, JEccWeight), k
        if isinstance(t, EccWeight):
            n_ecc += 1
            assert (t.k, t.n) == (r.k, r.n)
            # lo / hi: the port carries uint32 words as int32 bit patterns
            _structs_equal({f: getattr(r, f) for f in ("lo", "hi", "parity", "scale")},
                           {f: getattr(t, f) for f in ("lo", "hi", "parity", "scale")},
                           plane_dtypes={"uint32": "int32"})
        else:
            _structs_equal({"x": r}, {"x": t})
    assert n_ecc > 0 or arch in ("rwkv6-3b",)
    for shape, axes in MESHES[2:]:
        jm, tm = _meshes(shape, axes)
        for fsdp in (False, True):
            ref = _jflat(jecc.ecc_param_shardings(jcfg, jm, fsdp), is_leaf=is_j)
            port = tbase.flatten(tecc.ecc_param_shardings(cfg, tm, fsdp))
            for (k, r), (_, t) in zip(ref, port):
                if isinstance(r, JEccWeight):
                    assert [tuple(getattr(r, f).spec) for f in ("lo", "hi", "parity", "scale")] \
                        == [tuple(getattr(t, f).spec) for f in ("lo", "hi", "parity", "scale")], k
                else:
                    assert tuple(r.spec) == tuple(t.spec), k


# -- placement on a one-rank process group --------------------------------------------
def test_place_and_gather_on_one_rank(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(device="cpu")
        x = torch.arange(48.0).reshape(4, 12)
        for spec in (tshd.P(), tshd.P("data"), tshd.P(None, "model"), tshd.P("model", "data"),
                     tshd.P(("data", "model"))):
            placed = tshd.place(x, tshd.NamedSharding(mesh, spec))
            assert isinstance(placed, torch.distributed.tensor.DTensor)
            assert torch.equal(placed.to_local(), x)
            assert torch.equal(tshd.gather_leaf(placed), x)
        assert tuple(JP("model", ("pod", "data"))) == tuple(tshd.P("model", ("pod", "data")))
    finally:
        dist.destroy_process_group()
