"""The port's data-parallel training mesh against the reference's
(src/repro/distributed/collectives.py, the mesh tests of
tests/test_train_ckpt.py), at one rank and at two.

The reference runs at n = 1 and n = 2 in one subprocess that forces two
host devices before JAX starts; the port's two ranks are two processes of
a ``gloo`` group (``tests/_torch_dp_ranks.py``), started beside it, and its
one rank runs in this process. Both read one input file: the reference's
parameters, a batch, and per-rank gradients and error-feedback buffers.

Held: ``quantize_int8`` and ``compressed_psum`` bit for bit; the
data-parallel step's loss within 1e-5 relative, each averaged gradient
leaf within 1e-4 x max|ref| plus one int8 quantum of the leaf (compressed;
1e-4 x max|ref| plain), params within 1e-5 uncompressed; the reference's
compressed-against-uncompressed test; reshard on load and the elastic
rescale; a 12-step sharded trainer against the unsharded port trainer
within the trajectory tolerance 1e-3, its rail events (rank 0's scrub)
equal to the unsharded trainer's."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from conftest import tiny_cfg
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import lm as jlm
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import base as tbase
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import Trainer

import _torch_dp_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_cfg(vocab=64)
TCFG, TC, _ = ranks._setup()
LEAF_SHAPES = [(64, 128), (37,), (3, 5, 7), (1,)]
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, TRAJ_RTOL = 1e-5, 1e-4, 1e-5, 1e-3

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    sys.path.insert(0, sys.argv[2])
    from conftest import tiny_cfg
    from repro.distributed import collectives as c
    from repro.models import lm
    from repro.optim import adamw
    from repro.optim.adamw import AdamWConfig
    from repro.train.train_step import TrainConfig

    work = sys.argv[1]
    inp = np.load(os.path.join(work, "inputs.npz"))
    CFG = tiny_cfg(vocab=64)
    TC = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100),
                     remat=None)
    tree = {}
    for k in inp.files:
        if k.startswith("P"):
            node = tree
            *path, leaf = k[1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(inp[k])
    params = tree
    batch = {"tokens": jnp.asarray(inp["tokens"]), "labels": jnp.asarray(inp["labels"])}
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    out = {}
    for n in (1, 2):
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
        per = P("data")
        for i in range(int(inp["n_leaves"])):
            g, e = jnp.asarray(inp[f"G{i}"][:n]), jnp.asarray(inp[f"E{i}"][:n])

            def one(g, e):
                q, s = c.quantize_int8(g[0])
                avg, ef = c.compressed_psum(g[0], e[0], "data")
                return q[None], s[None], avg[None], ef[None]

            # op by op: each operation rounded on its own, as the formula reads
            res = shard_map(one, mesh=mesh, in_specs=(per, per), out_specs=(per,) * 4,
                            check_rep=False)(g, e)
            for name, r in zip(("q", "scale", "avg", "ef"), res):
                out[f"n{n}_{name}{i}"] = np.asarray(r)

        ef0 = c.init_error_feedback(params)
        for tag, compress in (("c", True), ("u", False)):
            def grads(params, ef, batch):
                def loss_fn(p):
                    return lm.train_loss(p, batch, CFG, remat=None)[0]
                loss, g = jax.value_and_grad(loss_fn)(params)
                loss = jax.lax.pmean(loss, "data")
                scales = jax.tree_util.tree_map(
                    lambda g, e: c.quantize_int8(g.astype(jnp.float32) + e)[1][None], g, ef)
                if compress:
                    pairs = jax.tree_util.tree_map(
                        lambda g, e: c.compressed_psum(g, e, "data"), g, ef)
                    is_pair = lambda t: isinstance(t, tuple)
                    avg = jax.tree_util.tree_map(lambda t: t[0], pairs, is_leaf=is_pair)
                else:
                    avg = jax.tree_util.tree_map(lambda g: jax.lax.pmean(g, "data"), g)
                return loss, avg, scales

            loss, avg, scales = jax.jit(shard_map(
                grads, mesh=mesh, in_specs=(P(), P(), per), out_specs=(P(), P(), per),
                check_rep=False))(params, ef0, batch)
            out[f"n{n}_loss_{tag}"] = np.asarray(loss)
            out.update({f"n{n}_grad_{tag}{k}": v for k, v in flat(avg).items()})
            out.update({f"n{n}_scale_{tag}{k}": v for k, v in flat(scales).items()})
            if not compress:  # the whole step, for its params
                step = jax.jit(c.make_dp_compressed_train_step(CFG, TC, mesh, compress=False))
                p1, _, _, loss1 = step(params, adamw.init(params, TC.optimizer), ef0, batch)
                out[f"n{n}_loss1_{tag}"] = np.asarray(loss1)
                out.update({f"n{n}_param_{tag}{k}": v for k, v in flat(p1).items()})
    np.savez(os.path.join(work, "ref.npz"), **out)
    print("ok")
""")


def _inputs(work: str) -> None:
    """The shared inputs: the reference's params, a batch, and two ranks'
    gradients and error feedback (with exact quantisation ties)."""
    params = jlm.init_params(CFG, jax.random.PRNGKey(0))
    out = {"P" + "/".join(p.key for p in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    batch = JTokenPipeline(JDataConfig(**ranks.DC_KW)).batch_at(0)
    out.update(tokens=batch["tokens"], labels=batch["labels"], n_leaves=len(LEAF_SHAPES))
    rng = np.random.default_rng(7)
    for i, shape in enumerate(LEAF_SHAPES):
        g = rng.standard_normal((2,) + shape).astype(np.float32)
        e = (rng.standard_normal((2,) + shape) * 0.01).astype(np.float32)
        if i == 0:  # max |g| 127/128, so the scale is 2^-7 and 0.5 and 2.5 quanta are ties
            g = rng.uniform(-0.95, 0.95, (2,) + shape).astype(np.float32)
            g[:, 0, :4] = np.array([127.0, 0.5, 2.5, -1.5], np.float32) / 128.0
            e[:] = 0.0
        out[f"G{i}"], out[f"E{i}"] = g, e
    np.savez(os.path.join(work, "inputs.npz"), **out)


def _spawn(cmds, env):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference at n = 1, 2 and the port's two ranks, side by side;
    then the port's one rank in this process."""
    import torch.distributed as dist

    work = str(tmp_path_factory.mktemp("dp"))
    one = os.path.join(work, "one")
    os.makedirs(one)
    _inputs(work)
    _inputs(one)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    rank_py = os.path.join(ROOT, "tests", "_torch_dp_ranks.py")
    _spawn([[sys.executable, "-c", REF_SCRIPT, work, os.path.join(ROOT, "tests")]]
           + [[sys.executable, rank_py, str(r), "2", work] for r in range(2)], env)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{one}/pg", world_size=1, rank=0)
    try:
        ranks.body(one)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(n)
    ref = dict(np.load(os.path.join(work, "ref.npz")))
    port = {1: [dict(np.load(os.path.join(one, "port_r0.npz")))],
            2: [dict(np.load(os.path.join(work, f"port_r{r}.npz"))) for r in range(2)]}
    info = {1: [json.load(open(os.path.join(one, "port_r0.json")))],
            2: [json.load(open(os.path.join(work, f"port_r{r}.json"))) for r in range(2)]}
    return ref, port, info


@pytest.mark.parametrize("n", [1, 2])
def test_quantize_and_compressed_psum_equal_the_reference_bit_for_bit(runs, n):
    ref, port, _ = runs
    for r in range(n):
        for i in range(len(LEAF_SHAPES)):
            for name in ("q", "scale", "avg", "ef"):
                want, got = ref[f"n{n}_{name}{i}"][r], port[n][r][f"{name}{i}"]
                assert want.dtype == got.dtype and np.array_equal(want, got), (r, i, name)
    # the tie values: 0.5 and 2.5 quanta round to even, as jnp.round does
    assert list(port[n][0]["q0"][0, :4]) == [127, 0, 2, -2]


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "plain"])
@pytest.mark.parametrize("n", [1, 2])
def test_dp_step_agrees_with_the_reference(runs, n, compress):
    ref, port, info = runs
    tag = "c" if compress else "u"
    want_loss = float(ref[f"n{n}_loss_{tag}"])
    if not compress:
        assert float(ref[f"n{n}_loss1_{tag}"]) == want_loss
    for r in range(n):
        assert info[n][r][f"loss_{tag}"] == pytest.approx(want_loss, rel=LOSS_RTOL)
        keys = [k[len(f"n{n}_grad_{tag}"):] for k in ref if k.startswith(f"n{n}_grad_{tag}")]
        assert keys and sorted(keys) == sorted(
            k[len(f"grad_{tag}"):] for k in port[n][r] if k.startswith(f"grad_{tag}"))
        for k in keys:
            want, got = ref[f"n{n}_grad_{tag}{k}"], port[n][r][f"grad_{tag}{k}"]
            quantum = float(ref[f"n{n}_scale_{tag}{k}"].max()) if compress else 0.0
            tol = GRAD_RTOL * float(np.abs(want).max()) + quantum
            assert float(np.abs(got - want).max()) <= tol, (r, k)
            if not compress:
                np.testing.assert_allclose(port[n][r][f"param_{tag}{k}"],
                                           ref[f"n{n}_param_{tag}{k}"], rtol=0, atol=PARAM_ATOL)
    if n == 2:  # every rank holds the same averaged gradients and params
        for k, v in port[2][0].items():
            if k.startswith(("grad_", "param_")):
                assert np.array_equal(v, port[2][1][k]), k


@pytest.mark.parametrize("n", [1, 2])
def test_compressed_dp_step_matches_uncompressed(runs, n):
    """The reference's test on the port: losses within 1e-5, params within
    5e-3, a non-zero error feedback."""
    _, port, info = runs
    for r in range(n):
        assert info[n][r]["loss_c"] == pytest.approx(info[n][r]["loss_u"], rel=1e-5)
        p = port[n][r]
        keys = [k[len("param_c"):] for k in p if k.startswith("param_c")]
        assert max(float(np.abs(p[f"param_c{k}"] - p[f"param_u{k}"]).max()) for k in keys) < 5e-3
        assert any(float(np.abs(p[f"ef_c{k}"]).max()) > 0 for k in keys)
        assert all(float(np.abs(p[f"ef_u{k}"]).max()) == 0 for k in keys)


@pytest.mark.parametrize("n", [1, 2])
def test_elastic_rescale_keeps_state(runs, n):
    """The reference's test on the port (the bitwise round trip is checked
    on each rank): training goes on after a rescale."""
    _, _, info = runs
    for r in range(n):
        l3, l4 = info[n][r]["rescale_losses"]
        assert np.isfinite(l4) and l4 < l3 + 1.0


@pytest.mark.parametrize("n", [1, 2])
def test_a_batch_that_does_not_split_is_computed_whole_on_every_rank(runs, n):
    _, _, info = runs
    assert all(info[n][r]["odd_batch_whole"] for r in range(n))


@pytest.mark.parametrize("n", [1, 2])
def test_a_trainer_without_a_mesh_keeps_its_own_checkpoints_in_a_group(runs, n):
    """In a process group, an unmeshed trainer on every rank saves alone to
    its own directory and restores from it; a DTensor tree without its
    group is refused."""
    _, _, info = runs
    for r in range(n):
        assert info[n][r]["own_checkpoints"] == [1, 2] and info[n][r]["own_restore"]


@pytest.mark.parametrize("n", [1, 2])
def test_a_recovery_without_a_checkpoint_places_the_state_again(runs, n):
    _, _, info = runs
    for r in range(n):
        assert info[n][r]["fault0"] == {"recoveries": 1, "step": 1, "placed": True}


def test_sharded_trainer_matches_the_unsharded_trainer(runs, tmp_path):
    _, _, info = runs
    from repro_torch.train.trainer import RailPolicy

    tr = Trainer(TCFG, TC, TokenPipeline(DataConfig(**ranks.DC_KW)), str(tmp_path),
                 ckpt_every=100, device="cpu", rails=RailPolicy(**ranks.RAILS_KW))
    tr.params = tbase.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jlm.init_params(CFG, jax.random.PRNGKey(0))), TCFG,
        device="cpu")
    tr.opt_state = tadamw.init(tr.params, TC.optimizer)
    hist = tr.run(ranks.TRAJ_STEPS)
    want = [r["loss"] for r in hist if "loss" in r]
    rails = [{k: r[k] for k in ("step", "voltages", "locked", "detected")}
             for r in hist if r.get("event") == "rails"]
    assert len(rails) == ranks.TRAJ_STEPS // ranks.RAILS_KW["scrub_every"]
    assert info[1][0]["traj"] == want  # one rank: the unsharded trainer bit for bit
    # rank 0 scrubs: the unsharded trainer's rail events; the other rank none
    assert info[1][0]["rails"] == info[2][0]["rails"] == json.loads(json.dumps(rails))
    assert info[2][1]["rails"] == []
    for r in range(2):
        np.testing.assert_allclose(info[2][r]["traj"], want, rtol=TRAJ_RTOL)
    assert info[2][0]["traj"] == info[2][1]["traj"]
    for n in (1, 2):
        for r in range(n):
            assert info[n][r]["resumed"] == info[n][r]["traj"][-2:]
            assert info[n][r]["resume_bitwise"]


def test_train_lm_example_on_two_torchrun_ranks(tmp_path):
    """``torchrun --nproc-per-node 2 examples/torch_train_lm.py --mesh``:
    the same failure and recovery from the sharded step-25 checkpoint as
    the one-process run, rank 0 printing, the losses within the trajectory
    tolerance (and the print's rounding)."""
    import importlib.util

    example = os.path.join(ROOT, "examples", "torch_train_lm.py")
    args = ["--steps", "30", "--fail-at", "27", "--batch", "8", "--seq", "32",
            "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", example, "--mesh", *args],
                         capture_output=True, text=True, env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines.count("*** simulated node failure at step 27 ***") == 1
    spec = importlib.util.spec_from_file_location("torch_train_lm", example)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    one = mod.main(args)
    final = lines[-1].split()
    assert final[0] == "arch=qwen3-0.6b" and final[1] == f"steps={len(one['losses'])}"
    assert final[-2] == "recoveries=1" == f"recoveries={one['recoveries']}"
    first, last = float(final[3]), float(final[5])
    assert first == pytest.approx(one["losses"][0], rel=TRAJ_RTOL, abs=5e-4)
    assert last == pytest.approx(one["losses"][-1], rel=TRAJ_RTOL, abs=5e-4)
