"""Port parity for the SECDED checkpoints: the on-disk layout against the
reference's (leaf files, check planes and manifests), a reference
checkpoint loaded by the port, correction and detection with the trainer's
fall-back, bf16 bits and pruning."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_cfg
from repro.checkpoint import manager as jckpt
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager as tckpt
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import base as tbase
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainConfig
from repro_torch.train.trainer import Trainer

CFG = tiny_cfg(vocab=64)
TCFG = tbase.ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=2, d_ff=128, vocab=64, head_dim=16)
DC = DataConfig(vocab=64, global_batch=8, seq_len=32)
TC = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100), remat=None)


@pytest.fixture(scope="module")
def states():
    """A float32 trainer state, {"params", "opt"} with nonzero moments and
    step 3, in both packages."""
    params = jlm.init_params(CFG, jax.random.PRNGKey(0))
    g = np.random.default_rng(0)
    noise = lambda p: jnp.asarray(g.standard_normal(p.shape).astype(np.float32))
    opt = jadamw.init(params, jadamw.AdamWConfig())
    opt = {"m": jax.tree_util.tree_map(noise, opt["m"]),
           "v": jax.tree_util.tree_map(lambda p: jnp.abs(noise(p)), opt["v"]),
           "step": jnp.asarray(3, jnp.int32)}
    jstate = {"params": params, "opt": opt}
    tstate = tbase.tree_map(lambda a: torch.from_numpy(np.array(a)),
                            jax.tree_util.tree_map(np.asarray, jstate))
    return jstate, tstate


def _files(path):
    return sorted(f for f in os.listdir(path))


def test_saved_layout_equals_the_references(states, tmp_path):
    jstate, tstate = states
    jckpt.save(str(tmp_path / "j"), 3, jstate, ecc_protect=True)
    tckpt.save(str(tmp_path / "t"), 3, tstate, ecc_protect=True)
    jd, td = tmp_path / "j" / "step_000003", tmp_path / "t" / "step_000003"
    assert _files(jd) == _files(td)
    assert (tmp_path / "t" / "LATEST").read_text() == (tmp_path / "j" / "LATEST").read_text()
    jm, tm = (json.loads((d / "manifest.json").read_text()) for d in (jd, td))
    assert set(tm) == set(jm)
    assert {k: v for k, v in tm.items() if k != "treedef"} == {
        k: v for k, v in jm.items() if k != "treedef"}
    assert tm["n_leaves"] == len(jax.tree_util.tree_leaves(jstate)) == 37
    for i in range(tm["n_leaves"]):
        assert (jd / f"leaf_{i:05d}.npy").read_bytes() == (td / f"leaf_{i:05d}.npy").read_bytes()
        zj, zt = np.load(jd / f"leaf_{i:05d}.ecc.npz"), np.load(td / f"leaf_{i:05d}.ecc.npz")
        assert sorted(zt.files) == sorted(zj.files) == ["nbytes", "parity"]
        assert zt["parity"].dtype == zj["parity"].dtype == np.uint8
        assert np.array_equal(zt["parity"], zj["parity"]) and int(zt["nbytes"]) == int(
            zj["nbytes"])


def test_leaf_order_is_the_references(states, tmp_path):
    """{"params", "opt"} saves "opt" first, inside it "m", "step", "v"."""
    _, tstate = states
    tckpt.save(str(tmp_path), 1, tstate)
    man = json.loads((tmp_path / "step_000001" / "manifest.json").read_text())
    keys = [k for k, _ in tbase.flatten(tstate)]
    assert keys[0].startswith("['opt']['m']") and keys[-1].startswith("['params']")
    step_at = keys.index("['opt']['step']")
    assert man["dtypes"][step_at] == "int32" and man["shapes"][step_at] == []
    assert np.load(tmp_path / "step_000001" / f"leaf_{step_at:05d}.npy") == 3


def test_a_reference_checkpoint_loads_in_the_port_bit_for_bit(states, tmp_path):
    jstate, tstate = states
    jckpt.save(str(tmp_path), 3, jstate, ecc_protect=True)
    back = tckpt.load(str(tmp_path), 3, tstate)
    for (k, a), (_, b) in zip(tbase.flatten(tstate), tbase.flatten(back)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), k
    # and a port checkpoint in the reference
    tckpt.save(str(tmp_path), 4, tstate, ecc_protect=True)
    jback = jckpt.load(str(tmp_path), 4, jstate)
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_ecc_corrects_single_bit_corruption(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(4096, dtype=torch.float32).reshape(64, 64)}
    tckpt.save(d, 1, tree, ecc_protect=True)
    path = os.path.join(d, "step_000001", "leaf_00000.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-100] ^= 0x04
    open(path, "wb").write(bytes(raw))
    assert not np.array_equal(np.load(path), tree["w"].numpy())
    out = tckpt.load(d, 1, tree)
    assert torch.equal(out["w"], tree["w"])  # corrected


def test_checkpoint_ecc_detects_multi_bit_and_falls_back(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(1024, dtype=torch.float32)}
    tckpt.save(d, 1, tree, ecc_protect=True)
    tckpt.save(d, 2, {"w": tree["w"] * 2}, ecc_protect=True)
    path = os.path.join(d, "step_000002", "leaf_00000.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-8] ^= 0x03  # two bits of one 64-bit word
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tckpt.CheckpointCorruption, match="1 uncorrectable words"):
        tckpt.load(d, 2, tree)
    # the trainer's restore() falls back past a corrupt checkpoint
    d = str(tmp_path / "trainer")
    tr = Trainer(TCFG, TC, TokenPipeline(DC), d, ckpt_every=5, ecc_checkpoints=True,
                 device="cpu")
    tr.save()  # step 0: a state the trainer can load
    tr.step = 3
    tr.save()
    leaf = os.path.join(d, "step_000003", "leaf_00000.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-8] ^= 0x03
    open(leaf, "wb").write(bytes(raw))
    assert tckpt.all_steps(d) and tckpt.latest_step(d) == 3
    assert tr.restore() and tr.step == 0


def test_bf16_bits_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(33, 7, generator=g).to(torch.bfloat16)
    w.view(torch.int16)[0, :3] = torch.tensor([0x7FC1, -1, 0x0001], dtype=torch.int16)  # NaN, ...
    tree = {"a": w, "b": torch.randn(5, generator=g)}
    tckpt.save(str(tmp_path), 7, tree, ecc_protect=True)
    man = json.loads((tmp_path / "step_000007" / "manifest.json").read_text())
    assert man["dtypes"] == ["bfloat16", "float32"] and man["shapes"][0] == [33, 7]
    stored = np.load(tmp_path / "step_000007" / "leaf_00000.npy")
    assert stored.dtype == np.uint16
    assert np.array_equal(stored, w.view(torch.int16).numpy().view(np.uint16))
    # the check plane covers the same bytes
    z = np.load(tmp_path / "step_000007" / "leaf_00000.ecc.npz")
    assert int(z["nbytes"]) == w.numel() * 2 and z["parity"].shape == (-(-w.numel() * 2 // 8),)
    back = tckpt.load(str(tmp_path), 7, tree)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"].view(torch.int16), w.view(torch.int16))
    raw = bytearray((tmp_path / "step_000007" / "leaf_00000.npy").read_bytes())
    raw[-10] ^= 0x10
    (tmp_path / "step_000007" / "leaf_00000.npy").write_bytes(bytes(raw))
    fixed = tckpt.load(str(tmp_path), 7, tree)
    assert torch.equal(fixed["a"].view(torch.int16), w.view(torch.int16))


def test_keep_prunes_old_checkpoints(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.zeros(4)}
    assert tckpt.all_steps(d) == [] and tckpt.latest_step(d) is None
    for s in (1, 2, 3, 5, 8):
        tckpt.save(d, s, tree, keep=2)
    assert sorted(tckpt.all_steps(d)) == [5, 8] and tckpt.latest_step(d) == 8
    assert not any(f.startswith(".tmp") for f in os.listdir(d))
    assert tckpt.all_steps(str(tmp_path / "missing")) == []


def test_checkpoint_reshard_on_load_on_one_rank(tmp_path):
    """The reference's test_checkpoint_reshard_on_load on a one-rank process
    group: the loaded leaf is a DTensor placed by the sharding, its values
    the reference's load of the same files; a corrected bit is corrected
    before the placement."""
    import torch.distributed as dist

    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch.mesh import compat_make_mesh
    from repro_torch.distributed import sharding as tshd
    from repro_torch.launch.mesh import make_host_mesh

    d = str(tmp_path / "ck")
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    tckpt.save(d, 1, {"w": torch.from_numpy(tree["w"])}, ecc_protect=True)
    jmesh = compat_make_mesh((1,), ("data",))
    want = np.asarray(jckpt.load(d, 1, tree, shardings={"w": NamedSharding(jmesh, P("data"))})["w"])
    raw = bytearray(open(os.path.join(d, "step_000001", "leaf_00000.npy"), "rb").read())
    raw[-20] ^= 0x08
    open(os.path.join(d, "step_000001", "leaf_00000.npy"), "wb").write(bytes(raw))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(device="cpu")
        shard = {"w": tshd.NamedSharding(mesh, tshd.P("data"))}
        out = tckpt.load(d, 1, tree, shardings=shard)
        assert isinstance(out["w"], torch.distributed.tensor.DTensor)
        assert out["w"].placements == tuple(tshd.placements(mesh, shard["w"].spec))
        assert np.array_equal(tshd.gather_leaf(out["w"]).numpy(), want)
        assert np.array_equal(out["w"].to_local().numpy(), tree["w"])
    finally:
        dist.destroy_process_group()
