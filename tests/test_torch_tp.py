"""The port's tensor- and expert-parallel training on the mesh's "model"
axis against the reference's jitted step on the same shardings
(src/repro/distributed/sharding.py's rules, src/repro/train/train_step.py),
at two ranks ((1, 2)) and at four ((2, 2), and (1, 4), where the two KV
heads stay whole).

The reference runs in one subprocess that forces four host devices before
JAX starts: ``jax.jit`` of its loss gradient and of ``make_train_step``
with ``in_shardings`` from ``param_shardings(cfg, mesh, fsdp=True)``, where
GSPMD computes each product on the shards. The port's ranks are processes
of a ``gloo`` group (``tests/_torch_tp_ranks.py``), one spawn a world size,
started beside it. All read one input file: the reference's parameters of
each config and a batch.

Held (the data-parallel mesh's tolerances, tests/test_torch_dp.py): the
loss within 1e-5 relative; each gradient shard within 1e-4 x max|ref grad|
of the reference's matching slice; the params after a step within 1e-5 of
the reference's, every element, once the reference's update is moved by
what AdamW's first step makes of the port's gradient instead of the
reference's (``_first_step_shift``); a 12-step trainer on the model axis
within 1e-3 of the unsharded port trainer. Replicated leaves' gradients are
the same on every model rank, and the leaves whose per-rank gradients are
partial before the sum over "model" are exactly ``lm.model_partial_keys``.
No rank gathers a leaf over "model" (the counter reads 0); a model axis of
one rank runs the data-parallel step (every leaf gathered whole) bit for
bit."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import base as jbase
from repro.models import lm as jlm
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import base as tbase
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import Trainer

import _torch_tp_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, TRAJ_RTOL = 1e-5, 1e-4, 1e-5, 1e-3
WORLDS = (2, 4)
CASES = [(w, name, shape) for w in WORLDS for name, shape in ranks.CASES[w]]

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    sys.path.insert(0, sys.argv[2])
    import _torch_tp_ranks as R
    from repro.distributed import sharding as shd
    from repro.models.base import ModelConfig
    from repro.optim import adamw
    from repro.optim.adamw import AdamWConfig
    from repro.train import train_step as ts

    work = sys.argv[1]
    inp = np.load(os.path.join(work, "inputs.npz"))
    batch = {"tokens": jnp.asarray(inp["tokens"]), "labels": jnp.asarray(inp["labels"])}
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    out = {}
    for w in (2, 4):
        for name, shape in R.CASES[w]:
            tag = f"{name}_{shape[0]}x{shape[1]}/"
            cfg = ModelConfig(**R.cfg_kw(name))
            tc = ts.TrainConfig(optimizer=AdamWConfig(**R.OPT_KW), remat="full")
            tree = {}
            for k in inp.files:
                if k.startswith(f"P{name}/"):
                    node = tree
                    *path, leaf = k[len(name) + 2:].split("/")
                    for p in path:
                        node = node.setdefault(p, {})
                    node[leaf] = jnp.asarray(inp[k])
            mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                        ("data", "model"))
            pshard = shd.param_shardings(cfg, mesh, fsdp=True)
            bshard = shd.batch_shardings(mesh, batch)
            opt = adamw.init(tree, tc.optimizer)
            oshard = {"m": pshard, "v": pshard, "step": shd.replicated(mesh)}
            with mesh:
                (loss, _), g = jax.jit(jax.value_and_grad(ts.make_loss_fn(cfg, tc), has_aux=True),
                                       in_shardings=(pshard, bshard))(tree, batch)
                p1, _, m = jax.jit(ts.make_train_step(cfg, tc),
                                   in_shardings=(pshard, oshard, bshard))(tree, opt, batch)
            out[tag + "loss"] = np.asarray(loss)
            out[tag + "loss1"] = np.asarray(m["loss"])
            out.update({tag + "grad" + k: v for k, v in flat(g).items()})
            out.update({tag + "param" + k: v for k, v in flat(p1).items()})
    np.savez(os.path.join(work, "ref.npz"), **out)
    print("ok")
""")


def _jcfg(name: str):
    return jbase.ModelConfig(**ranks.cfg_kw(name))


def _inputs(work: str) -> None:
    """The reference's params of every config and one batch."""
    out = {}
    for name in ranks.CONFIGS:
        params = jlm.init_params(_jcfg(name), jax.random.PRNGKey(0))
        out.update({f"P{name}/" + "/".join(p.key for p in path): np.asarray(v)
                    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    batch = JTokenPipeline(JDataConfig(**ranks.DC_KW)).batch_at(0)
    out.update(tokens=batch["tokens"], labels=batch["labels"])
    np.savez(os.path.join(work, "inputs.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and the port's 2- and 4-rank groups, side by side."""
    work = str(tmp_path_factory.mktemp("tp"))
    dirs = {w: os.path.join(work, f"w{w}") for w in WORLDS}
    for d in dirs.values():
        os.makedirs(d)
        _inputs(d)
    _inputs(work)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    rank_py = os.path.join(ROOT, "tests", "_torch_tp_ranks.py")
    cmds = [[sys.executable, "-c", REF_SCRIPT, work, os.path.join(ROOT, "tests")]]
    cmds += [[sys.executable, rank_py, str(r), str(w), dirs[w]] for w in WORLDS for r in range(w)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for c in cmds]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for c, p, (_, err) in zip(cmds, procs, outs):
        assert p.returncode == 0, f"{c[1:]} exited {p.returncode}: {err[-3000:]}"
    ref = dict(np.load(os.path.join(work, "ref.npz")))
    port = {w: [dict(np.load(os.path.join(dirs[w], f"port_r{r}.npz"))) for r in range(w)]
            for w in WORLDS}
    info = {w: [json.load(open(os.path.join(dirs[w], f"port_r{r}.json"))) for r in range(w)]
            for w in WORLDS}
    return ref, port, info


def _tag(name, shape) -> str:
    return f"{name}_{shape[0]}x{shape[1]}/"


def _slice_like(full: np.ndarray, local_shape, dim, index: int) -> np.ndarray:
    """The model rank ``index``'s slice of ``full`` along ``dim`` (None:
    whole), of ``local_shape[dim]`` elements."""
    if dim is None:
        return full
    n = local_shape[dim]
    return np.take(full, range(index * n, (index + 1) * n), axis=dim)


def _first_step_shift(g_port: np.ndarray, g_ref: np.ndarray, clip: float) -> np.ndarray:
    """The change in a parameter after AdamW's first step when its gradient
    is ``g_port`` rather than ``g_ref``: that step moves each element by
    lr x g / (|g| + eps) (the bias-corrected moments are g and g^2), so an
    element whose gradient is within rounding of zero moves by up to 2 lr
    whatever its accuracy (1e-5 at a gradient near 2.5e-8 of a leaf whose
    largest is 0.05), while a resolved element moves by lr x sign(g)."""
    opt = tadamw.AdamWConfig(**ranks.OPT_KW)
    import torch

    lr = float(tadamw.schedule(opt, torch.tensor(1)))
    u = lambda g: (g * clip) / (np.abs(g * clip) + opt.eps)
    return lr * (u(g_port.astype(np.float64)) - u(g_ref.astype(np.float64)))


@pytest.mark.parametrize("world,name,shape", CASES, ids=[f"{n}-{s[0]}x{s[1]}" for _, n, s in CASES])
def test_model_axis_step_agrees_with_the_reference(runs, world, name, shape):
    ref, port, info = runs
    tag = _tag(name, shape)
    want_loss = float(ref[tag + "loss"])
    assert float(ref[tag + "loss1"]) == pytest.approx(want_loss, rel=1e-6)
    for r in range(world):
        got, meta = port[world][r], info[world][r][tag]
        assert meta["loss"] == pytest.approx(want_loss, rel=LOSS_RTOL), r
        keys = [k[len(tag + "grad"):] for k in ref if k.startswith(tag + "grad")]
        assert keys and sorted(keys) == sorted(meta["model_dims"])
        norm = np.sqrt(sum(np.sum(np.square(ref[tag + "grad" + k].astype(np.float64)))
                           for k in keys))
        clip = min(1.0, tadamw.AdamWConfig().grad_clip / norm)
        for k in keys:
            dim, mi = meta["model_dims"][k], meta["model_index"]
            g_ref = ref[tag + "grad" + k]
            g = got[tag + "grad" + k]
            want = _slice_like(g_ref, g.shape, dim, mi)
            assert g.shape == want.shape, (r, k)
            tol = GRAD_RTOL * float(np.abs(g_ref).max())
            assert float(np.abs(g - want).max()) <= tol, (r, k, float(np.abs(g - want).max()), tol)
            p = got[tag + "param" + k]
            p_ref = _slice_like(ref[tag + "param" + k], p.shape, dim, mi)
            np.testing.assert_allclose(p, p_ref - _first_step_shift(g, want, clip), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{r} {k}")
        assert meta["repeat_bitwise"] and meta["moments_local"]


@pytest.mark.parametrize("world,name,shape", CASES, ids=[f"{n}-{s[0]}x{s[1]}" for _, n, s in CASES])
def test_no_rank_gathers_a_leaf_over_model(runs, world, name, shape):
    """The step gathers over the batch axes only; every model-sharded leaf
    stays a shard of 1 / n of the leaf on every rank."""
    _, _, info = runs
    for r in range(world):
        meta = info[world][r][_tag(name, shape)]
        assert meta["gathered"].get("model", 0) == 0
        assert (meta["gathered"].get("data", 0) > 0) == (shape[0] > 1)
        cfg = ranks._setup(name)[0]
        from repro_torch.models import lm

        full = {k: list(v.shape) for k, v in tbase.flatten(lm.param_struct(cfg))}
        for k, dim in meta["model_dims"].items():
            local = meta["local_sizes"][k]
            if dim is not None:
                assert local[dim] * shape[1] == full[k][dim], (k, local, full[k])
    assert info[world][0]["traj_gathered"].get("model", 0) == 0


@pytest.mark.parametrize("world,name,shape", CASES, ids=[f"{n}-{s[0]}x{s[1]}" for _, n, s in CASES])
def test_replicated_gradients_are_equal_on_every_model_rank(runs, world, name, shape):
    """After the step's sum over "model" every replicated leaf's gradient is
    the same bits on every model rank; before it, exactly the leaves of
    ``lm.model_partial_keys`` differ (each rank holds its heads' part):
    ``q_norm`` / ``k_norm`` where the q heads are sharded, and ``wk`` / ``wv``
    (``bk`` / ``bv``) where the KV heads stay whole; the MoE router never."""
    _, port, info = runs
    tag = _tag(name, shape)
    rows = {}
    for r in range(world):
        rows.setdefault(info[world][r][tag]["batch_index"], []).append(r)
    partial = set(info[world][0][tag]["partial"])
    dims = info[world][0][tag]["model_dims"]
    replicated = [k for k, d in dims.items() if d is None]
    differ = set()
    for same_row in rows.values():
        assert len(same_row) == shape[1]
        for k in replicated:
            grads = [port[world][r][tag + "grad" + k] for r in same_row]
            assert all(np.array_equal(grads[0], g) for g in grads[1:]), k
            raws = [port[world][r][tag + "raw" + k] for r in same_row]
            if not all(np.array_equal(raws[0], g) for g in raws[1:]):
                differ.add(k)
    assert differ == partial
    assert all("router" not in k for k in partial)
    if name == "dense":
        assert {k.split("'")[-2] for k in partial} == (
            {"q_norm", "k_norm"} if shape[1] == 2 else
            {"q_norm", "k_norm", "wk", "wv", "bk", "bv"})


EMULATED = [(w, n, s) for w, n, s in CASES if s[0] == 1]


@pytest.mark.parametrize("world,name,shape", EMULATED,
                         ids=[f"{n}-{s[0]}x{s[1]}" for _, n, s in EMULATED])
def test_the_ranks_step_equals_its_one_process_emulation(runs, world, name, shape):
    """``train_step.emulate_model_step`` (every rank's branch in turn, the
    ranks' sums in rank order) gives each rank's loss, local params and
    moments bit for bit."""
    _, _, info = runs
    assert all(info[world][r][_tag(name, shape)]["emulation_bitwise"] for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
def test_a_model_axis_of_one_rank_runs_the_data_parallel_step(runs, world):
    _, _, info = runs
    assert all(info[world][r]["model_one_bitwise"] for r in range(world))


def test_model_axis_trainer_matches_the_unsharded_trainer(runs, tmp_path):
    """12 steps of ``Trainer(mesh=)`` on the rules' shardings of (1, 2) and
    (2, 2) against the unsharded port trainer, from the reference's params."""
    _, _, info = runs
    cfg, tc, _ = ranks._setup("dense")
    tr = Trainer(cfg, tc, TokenPipeline(DataConfig(**ranks.DC_KW)), str(tmp_path),
                 ckpt_every=100, device="cpu")
    tr.params = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jlm.init_params(_jcfg("dense"), jax.random.PRNGKey(0))),
        cfg, device="cpu")
    tr.opt_state = tadamw.init(tr.params, tc.optimizer)
    want = [r["loss"] for r in tr.run(ranks.TRAJ_STEPS) if "loss" in r]
    for w in WORLDS:
        for r in range(w):
            got = info[w][r]["traj"]
            assert len(got) == ranks.TRAJ_STEPS and got == info[w][0]["traj"]
            np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_rescale_and_ecc_reshard_between_the_two_meshes(runs):
    """At two ranks: a rescale from (1, 2) to (2, 1) keeps the state bit for
    bit and training goes on after it and after the rescale back; an ECC
    save at (1, 2) loaded onto (2, 1)'s shardings gives each rank its slices
    bit for bit."""
    _, _, info = runs
    traj = info[2][0]["traj"]
    for r in range(2):
        meta = info[2][r]
        assert meta["rescale_to_21_bitwise"] and meta["ecc_reshard_bitwise"]
        assert all(np.isfinite(x) and x < traj[-1] + 1.0 for x in meta["rescale_losses"])
