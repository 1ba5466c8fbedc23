"""The port's dry-run analytic model against the reference's
(src/repro/launch/dryrun.py).

``repro.launch.dryrun`` sets XLA_FLAGS to 512 host devices when it is
imported, so the reference side runs in one subprocess that prints its
numbers as JSON (floats round-trip exactly through ``repr``). Every LM arch
x its shapes x both pod meshes x FSDP on and off: ``model_flops``,
``ssm_correction_flops``, ``analytic_memory_bytes`` (at both moment
widths) and ``_cache_bytes`` equal the reference's floats exactly; and
``build_cell``'s inputs (shapes, dtypes) and shardings (specs) equal the
reference's leaf by leaf for every cell on the (16, 16) pod (FSDP by the
parameter threshold) and, for four archs, on the (2, 16, 16) pod with FSDP
on and off."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCHS, get_config, supported_shapes
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import base, lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in ARCHS if a != "paper-nn"]
MODE_ARCHS = ["qwen3-0.6b", "mixtral-8x22b", "llama-3.2-vision-11b", "rwkv6-3b"]

REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    from repro.configs import ARCHS, get_config, supported_shapes
    from repro.configs.shapes import SHAPES
    from repro.launch import dryrun
    from repro.launch.mesh import compat_abstract_mesh

    from repro.models import lm

    lm_archs, mode_archs = json.loads(sys.argv[1])
    meshes = {"16x16": compat_abstract_mesh((16, 16), ("data", "model")),
              "2x16x16": compat_abstract_mesh((2, 16, 16), ("pod", "data", "model"))}

    def dt(x):
        return "bfloat16" if str(x.dtype) == "bfloat16" else str(jnp.dtype(x.dtype))

    def leaves(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return [(jax.tree_util.keystr(p), x) for p, x in flat]

    def cell(cfg, shape, mesh, fsdp):
        _, args, shards, _ = dryrun.build_cell(cfg, shape, mesh, fsdp=fsdp)
        return [[[k, list(x.shape), dt(x), list(sh.spec)]
                 for (k, x), (_, sh) in zip(leaves(a), leaves(s))]
                for a, s in zip(args, shards)]

    rec = {"numbers": {}, "cells": {}}
    for arch in lm_archs:
        cfg = get_config(arch)
        for shape in supported_shapes(arch):
            sh = SHAPES[shape]
            for mname, mesh in meshes.items():
                chips = 1
                for v in mesh.shape.values():
                    chips *= v
                rec["numbers"][f"{arch}|{shape}|{mname}"] = {
                    "model_flops": dryrun.model_flops(cfg, shape),
                    "ssm": dryrun.ssm_correction_flops(cfg, shape),
                    "cache": dryrun._cache_bytes(cfg, sh, chips),
                    "mem": {f"{fsdp}|{ob}": dryrun.analytic_memory_bytes(
                        cfg, shape, mesh, fsdp, ob)["per_device"]
                        for fsdp in (False, True) for ob in (4, 8)}}
            auto = lm.param_count(cfg)[0] >= dryrun.FSDP_THRESHOLD
            rec["cells"][f"{arch}|{shape}|16x16|{auto}"] = cell(cfg, shape, meshes["16x16"], auto)
            if arch in mode_archs:
                for fsdp in (False, True):
                    rec["cells"][f"{arch}|{shape}|2x16x16|{fsdp}"] = \\
                        cell(cfg, shape, meshes["2x16x16"], fsdp)
    print(json.dumps(rec))
""")


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          json.dumps([LM_ARCHS, MODE_ARCHS])],
                         capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _meshes():
    return {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_analytic_numbers_equal_the_reference(ref, arch):
    cfg = get_config(arch)
    for shape in supported_shapes(arch):
        for mname, mesh in _meshes().items():
            r = ref["numbers"][f"{arch}|{shape}|{mname}"]
            chips = 1
            for v in mesh.sizes:
                chips *= v
            assert dryrun.model_flops(cfg, shape) == r["model_flops"]
            assert dryrun.ssm_correction_flops(cfg, shape) == r["ssm"]
            assert dryrun._cache_bytes(cfg, SHAPES[shape], chips) == r["cache"]
            for fsdp in (False, True):
                for ob in (4, 8):
                    got = dryrun.analytic_memory_bytes(cfg, shape, mesh, fsdp, ob)["per_device"]
                    assert got == r["mem"][f"{fsdp}|{ob}"], (shape, mname, fsdp, ob)


def _cell(cfg, shape, mesh, fsdp):
    args, shards = dryrun.build_cell(cfg, shape, mesh, fsdp)
    out = []
    for a, s in zip(args, shards):
        out.append([[k, list(x.shape), str(x.dtype).removeprefix("torch."), list(sh.spec)]
                    for (k, x), (_, sh) in zip(base.flatten(a), base.flatten(s))])
        assert all(x.device.type == "meta" for _, x in base.flatten(a))
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_build_cell_equals_the_reference(ref, arch):
    cfg = get_config(arch)
    meshes = _meshes()
    auto = lm.param_count(cfg)[0] >= dryrun.FSDP_THRESHOLD
    for shape in supported_shapes(arch):
        cells = [("16x16", auto)]
        if arch in MODE_ARCHS:
            cells += [("2x16x16", False), ("2x16x16", True)]
        for mname, fsdp in cells:
            want = ref["cells"][f"{arch}|{shape}|{mname}|{fsdp}"]
            got = _cell(cfg, shape, meshes[mname], fsdp)
            assert got == want, (shape, mname, fsdp)


def test_cli_prints_a_cell(capsys):
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k", "--mesh", "both"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [r["mesh"] for r in lines] == ["16x16", "2x16x16"]
    cfg = get_config("qwen3-0.6b")
    for r in lines:
        assert r["model_flops_global"] == dryrun.model_flops(cfg, "train_4k")
        assert r["param_bytes_per_device"] > 0 and not r["fsdp"]
    # replicated over "data", cut over "model": the 2-pod mesh holds the same
    # parameter bytes a device and half the batch
    assert lines[0]["param_bytes_per_device"] == lines[1]["param_bytes_per_device"]
