"""The port's model-axis training for the rwkv6, hybrid (mamba with
attention and MoE), vlm and audio families against the reference's jitted
step on the same shardings (src/repro/distributed/sharding.py's rules,
src/repro/train/train_step.py), on (1, 2), (2, 2) and (1, 4) meshes, and an
rwkv6 config of three heads on (1, 2), where the rule leaves time-mix and
the receptance gate whole while "ffn" and the vocab shard.

As tests/test_torch_tp.py: the reference runs in subprocesses that force
four host devices before JAX starts (two, each jitting every other case)
and jit its loss gradient with ``in_shardings`` from
``param_shardings(cfg, mesh, fsdp=True)`` and ``batch_shardings`` of the
config's batch (an audio config's (B, K, S) tokens and labels, a vlm's
image embeddings), where GSPMD computes each product on the shards, then
AdamW's update of that gradient (``make_train_step``'s second half); the port's
ranks are processes of a ``gloo`` group (``tests/_torch_tp_families_ranks.py``),
one spawn a world size, started beside it. All read one input file: the
reference's parameters of each config, their constant leaves (zeros, ones,
the cross gates) moved off their constants by seeded numbers so every path
carries a gradient, and each config's batch.

Held at test_torch_tp.py's tolerances: the loss within 1e-5 relative; each
gradient shard within 1e-4 x max|ref grad|; the params after a step within
1e-5 after ``_first_step_shift``; 12-step trainers of rwkv6 and hybrid on
the model axis within 1e-3 of the unsharded port trainer. No leaf is
gathered over "model" (the counter reads 0), while the gathered
activations are counted apart; replicated leaves' gradients are the same
on every model rank, and the leaves whose per-rank gradients are partial
are exactly ``lm.model_partial_keys``; the ranks equal
``emulate_model_step`` bit for bit; a model axis of one rank runs the
data-parallel step; rwkv6 rescales (1, 2) <-> (2, 1)."""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import base as jbase
from repro.models import lm as jlm
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import base as tbase
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import Trainer

import _torch_tp_families_ranks as ranks
from test_torch_tp import _first_step_shift, _slice_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, TRAJ_RTOL = 1e-5, 1e-4, 1e-5, 1e-3
WORLDS = (2, 4)
REF_PARTS = 3  # reference processes, each jitting every REF_PARTS-th case
CASES = [(w, name, shape) for w in WORLDS for name, shape in ranks.CASES[w]]
IDS = [f"{n}-{s[0]}x{s[1]}" for _, n, s in CASES]

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    sys.path.insert(0, sys.argv[2])
    import _torch_tp_families_ranks as R
    from repro.distributed import sharding as shd
    from repro.models.base import ModelConfig
    from repro.optim import adamw
    from repro.optim.adamw import AdamWConfig
    from repro.train import train_step as ts

    work, part = sys.argv[1], int(sys.argv[3])
    inp = np.load(os.path.join(work, "inputs.npz"))
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}

    def tree(prefix):
        out = {}
        for k in inp.files:
            if k.startswith(prefix):
                node = out
                *path, leaf = k[len(prefix):].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(inp[k])
        return out

    out = {}
    cases = [(name, shape) for w in (2, 4) for name, shape in R.CASES[w]]
    for name, shape in cases[part::REF_PARTS]:
        tag = f"{name}_{shape[0]}x{shape[1]}/"
        cfg = ModelConfig(**R.cfg_kw(name))
        tc = ts.TrainConfig(optimizer=AdamWConfig(**R.OPT_KW), remat="full")
        params, batch = tree(f"P{name}/"), tree(f"B{name}/")
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                    ("data", "model"))
        pshard = shd.param_shardings(cfg, mesh, fsdp=True)
        bshard = shd.batch_shardings(mesh, batch)
        opt = adamw.init(params, tc.optimizer)
        oshard = {"m": pshard, "v": pshard, "step": shd.replicated(mesh)}
        with mesh:  # make_train_step's two halves, the gradient's jit sharded
            (loss, _), g = jax.jit(jax.value_and_grad(ts.make_loss_fn(cfg, tc), has_aux=True),
                                   in_shardings=(pshard, bshard))(params, batch)
            p1, _, _ = jax.jit(lambda g, o, p: adamw.update(g, o, p, tc.optimizer))(
                g, jax.device_put(opt, oshard), jax.device_put(params, pshard))
        out[tag + "loss"] = np.asarray(loss)
        out.update({tag + "grad" + k: v for k, v in flat(g).items()})
        out.update({tag + "param" + k: v for k, v in flat(p1).items()})
    np.savez(os.path.join(work, f"ref{part}.npz"), **out)
    print("ok")
""")


def _jcfg(name: str):
    return jbase.ModelConfig(**ranks.cfg_kw(name))


@functools.cache
def _ref_params(name: str) -> dict:
    """The reference's draw as numpy, each constant leaf (zeros, ones, the
    cross gates) moved off its constant by seeded numbers in [-0.3, 0.3)."""
    g = np.random.default_rng(7)
    out = {}
    params = jlm.init_params(_jcfg(name), jax.random.PRNGKey(0))
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        a = np.asarray(v)
        if np.all(a == a.flat[0]):
            a = (a + g.uniform(-0.3, 0.3, a.shape)).astype(a.dtype)
        out["/".join(p.key for p in path)] = a
    return out


def _batch(name: str) -> dict:
    cfg = _jcfg(name)
    b = JTokenPipeline(JDataConfig(**ranks.DC_KW, n_codebooks=cfg.n_codebooks)).batch_at(0)
    if cfg.family == "vlm":
        g = np.random.default_rng(11)
        b["img"] = g.standard_normal((b["tokens"].shape[0], cfg.n_img_tokens, cfg.d_model)
                                     ).astype(np.float32)
    return b


def _inputs(*works: str) -> None:
    """The reference's params and a batch of every config, in each of
    ``works``."""
    out = {}
    for name in ranks.CONFIGS:
        out.update({f"P{name}/{k}": v for k, v in _ref_params(name).items()})
        out.update({f"B{name}/{k}": v for k, v in _batch(name).items()})
    for work in works:
        np.savez(os.path.join(work, "inputs.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and the port's 2- and 4-rank groups, side by side."""
    work = str(tmp_path_factory.mktemp("tpf"))
    dirs = {w: os.path.join(work, f"w{w}") for w in WORLDS}
    for d in dirs.values():
        os.makedirs(d)
    _inputs(work, *dirs.values())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    rank_py = os.path.join(ROOT, "tests", "_torch_tp_families_ranks.py")
    script = REF_SCRIPT.replace("REF_PARTS", str(REF_PARTS))
    cmds = [[sys.executable, "-c", script, work, os.path.join(ROOT, "tests"), str(k)]
            for k in range(REF_PARTS)]
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
    ref = {k: v for i in range(REF_PARTS)
           for k, v in np.load(os.path.join(work, f"ref{i}.npz")).items()}
    port = {w: [dict(np.load(os.path.join(dirs[w], f"port_r{r}.npz"))) for r in range(w)]
            for w in WORLDS}
    info = {w: [json.load(open(os.path.join(dirs[w], f"port_r{r}.json"))) for r in range(w)]
            for w in WORLDS}
    return ref, port, info


def _tag(name, shape) -> str:
    return f"{name}_{shape[0]}x{shape[1]}/"


@pytest.mark.parametrize("world,name,shape", CASES, ids=IDS)
def test_model_axis_step_agrees_with_the_reference(runs, world, name, shape):
    ref, port, info = runs
    tag = _tag(name, shape)
    want_loss = float(ref[tag + "loss"])
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


@pytest.mark.parametrize("world,name,shape", CASES, ids=IDS)
def test_no_rank_gathers_a_leaf_over_model(runs, world, name, shape):
    """The step gathers leaves over the batch axes only, and every
    model-sharded leaf stays a shard of 1 / n of the leaf on every rank;
    the activations that ``ModelAxis.gather`` moves (mamba's in_proj
    products, rwkv6's receptance gate) are counted apart."""
    _, _, info = runs
    cfg = ranks._setup(name)[0]
    full = {k: list(v.shape) for k, v in tbase.flatten(lm.param_struct(cfg))}
    for r in range(world):
        meta = info[world][r][_tag(name, shape)]
        assert meta["gathered"].get("model", 0) == 0
        assert (meta["gathered"].get("data", 0) > 0) == (shape[0] > 1)
        assert (meta["activation_bytes"] > 0) == (name in ("rwkv", "hybrid")), meta
        sharded = 0
        for k, dim in meta["model_dims"].items():
            local = meta["local_sizes"][k]
            if dim is not None:
                sharded += 1
                assert local[dim] * shape[1] == full[k][dim], (k, local, full[k])
        assert sharded > 0
    for n in ranks.TRAJ_CONFIGS:
        assert info[world][0][f"traj_gathered_{n}"].get("model", 0) == 0


@pytest.mark.parametrize("world,name,shape", CASES, ids=IDS)
def test_replicated_gradients_are_equal_on_every_model_rank(runs, world, name, shape):
    """After the step's sum over "model" every replicated leaf's gradient is
    the same bits on every model rank; before it, exactly the leaves of
    ``lm.model_partial_keys`` differ: none for rwkv6 and audio, whose
    replicated leaves are read outside the regions or enter them as
    activations; ``wk`` / ``wv`` of the hybrid's attention where its two KV
    heads stay whole; a vlm's ``q_norm`` / ``k_norm`` (and ``wk`` / ``wv``
    at four ranks), its cross layer's among them, never its gates."""
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
    names = {k.split("'")[-2] for k in partial}
    want = {"rwkv": set(), "rwkv3": set(), "audio": set(),
            "hybrid": set() if shape[1] == 2 else {"wk", "wv"},
            "vlm": {"q_norm", "k_norm"} | (set() if shape[1] == 2 else {"wk", "wv"})}[name]
    assert names == want
    if name == "vlm":
        assert any("['p4']" in k for k in partial)  # the cross layer's


EMULATED = [(w, n, s) for w, n, s in CASES if s[0] == 1]


@pytest.mark.parametrize("world,name,shape", EMULATED,
                         ids=[f"{n}-{s[0]}x{s[1]}" for _, n, s in EMULATED])
def test_the_ranks_step_equals_its_one_process_emulation(runs, world, name, shape):
    """``train_step.emulate_model_step`` gives each rank's loss, local
    params and moments bit for bit."""
    _, _, info = runs
    assert all(info[world][r][_tag(name, shape)]["emulation_bitwise"] for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
def test_a_model_axis_of_one_rank_runs_the_data_parallel_step(runs, world):
    _, _, info = runs
    assert all(info[world][r]["model_one_bitwise"] for r in range(world))


@pytest.mark.parametrize("name", ranks.TRAJ_CONFIGS)
def test_model_axis_trainer_matches_the_unsharded_trainer(runs, tmp_path, name):
    """12 steps of ``Trainer(mesh=)`` on the rules' shardings of (1, 2) and
    (2, 2) against the unsharded port trainer, from the same params."""
    _, _, info = runs
    cfg, tc, _ = ranks._setup(name)
    tr = Trainer(cfg, tc, TokenPipeline(DataConfig(**ranks.DC_KW)), str(tmp_path),
                 ckpt_every=100, device="cpu")
    tr.params = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, _unflatten(_ref_params(name))), cfg, device="cpu")
    tr.opt_state = tadamw.init(tr.params, tc.optimizer)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: more threads only contend with the other workers
    try:
        want = [r["loss"] for r in tr.run(ranks.TRAJ_STEPS) if "loss" in r]
    finally:
        torch.set_num_threads(threads)
    for w in WORLDS:
        for r in range(w):
            got = info[w][r][f"traj_{name}"]
            assert len(got) == ranks.TRAJ_STEPS and got == info[w][0][f"traj_{name}"]
            np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def _unflatten(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_rescale_and_ecc_reshard_between_the_two_meshes(runs):
    """rwkv6 at two ranks: a rescale from (1, 2) to (2, 1) keeps the state
    bit for bit and training goes on after it and after the rescale back;
    an ECC save at (1, 2) loaded onto (2, 1)'s shardings gives each rank
    its slices bit for bit."""
    _, _, info = runs
    traj = info[2][0]["traj_rwkv"]
    for r in range(2):
        meta = info[2][r]
        assert meta["rescale_to_21_bitwise"] and meta["ecc_reshard_bitwise"]
        assert all(np.isfinite(x) and x < traj[-1] + 1.0 for x in meta["rescale_losses"])
