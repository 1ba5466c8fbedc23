"""The dry run's analytic model of an (arch x shape x mesh) cell, and a CLI
that prints a cell's bytes per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh 16x16

Kept from the reference's dry run (``src/repro/launch/dryrun.py``), to the
same floats: ``model_flops``, ``ssm_correction_flops`` (the recurrent scans'
FLOPs), ``analytic_memory_bytes`` (the fusion-aware HBM traffic model per
device) and ``_cache_bytes``; and ``build_cell``, a cell's step inputs and
their shardings on the meta device (nothing allocated), on the pod meshes
of ``launch.mesh.make_production_mesh``.

Left out, and why:
  * the 512-host-device XLA flag set at import: it makes JAX's CPU backend
    fake a TPU pod so the reference can lower on it. The port's analytic
    model reads only a mesh's axes and sizes, which an abstract mesh has.
  * lowering and compiling each cell (XLA's memory and cost analyses, the
    1-/2-group unrolled extrapolation): they read XLA's compiled SPMD
    program, and an eager PyTorch step has no such whole-program artefact.
  * the collective parser of optimised HLO text, for the same reason.
  * the step function, donated arguments and the other sharding modes,
    ECC serve weights, microbatches, remat and moment-dtype knobs of the
    reference's ``build_cell``: they feed the lowering; the analytic model
    and the bytes per device read only the inputs and their shardings.
  * the TPU v5e roofline constants and the times derived from them: they
    are a TPU's numbers, and the port states none.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from repro_torch.configs import ARCHS, get_config, supported_shapes
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import base, lm
from repro_torch.optim import adamw

FSDP_THRESHOLD = 6e9  # params above this are FSDP-sharded
BF16_OPT_THRESHOLD = 60e9  # params above this use bf16 adam moments


def model_flops(cfg, shape_name: str) -> float:
    total, active = lm.param_count(cfg)
    sh = SHAPES[shape_name]
    if sh.kind == "train":
        return 6.0 * active * sh.global_batch * sh.seq_len
    if sh.kind == "prefill":
        return 2.0 * active * sh.global_batch * sh.seq_len
    return 2.0 * active * sh.global_batch  # decode: per emitted token


def build_cell(cfg, shape_name: str, mesh, fsdp: bool):
    """(args, shardings) of one cell: the step's inputs as meta tensors and
    their sharding trees, by the reference's rules (its default "tp_dp"
    mode). Train cells carry the AdamW moments, in bfloat16 above
    ``BF16_OPT_THRESHOLD`` parameters."""
    total, _ = lm.param_count(cfg)
    pstruct = lm.param_struct(cfg)
    pshard = shd.param_shardings(cfg, mesh, fsdp)
    sh = SHAPES[shape_name]
    specs = input_specs(cfg, shape_name)

    if sh.kind == "train":
        opt_dtype = torch.bfloat16 if total >= BF16_OPT_THRESHOLD else torch.float32
        opt_struct = adamw.init(pstruct, adamw.AdamWConfig(state_dtype=opt_dtype))
        opt_shard = {"m": pshard, "v": pshard, "step": shd.replicated(mesh)}
        batch_shard = base.tree_map(lambda leaf: shd.data_sharding(mesh, leaf.shape[0]), specs)
        return (pstruct, opt_struct, specs), (pshard, opt_shard, batch_shard)

    cache = specs["cache"]
    args = [pstruct, specs["tokens"], cache]
    shards = [pshard, shd.data_sharding(mesh, sh.global_batch),
              shd.cache_shardings(cfg, mesh, cache)]
    if sh.kind == "decode":
        args.append(specs["pos"])
        shards.append(shd.replicated(mesh))
    if "img" in specs:
        args.append(specs["img"])
        shards.append(shd.data_sharding(mesh, sh.global_batch))
    return tuple(args), tuple(shards)


def ssm_correction_flops(cfg, shape_name: str) -> float:
    """Analytic FLOPs of the mamba / rwkv inner recurrence scans (global):
    the reference's lowered scans stay loops whose trip counts its cost
    analysis misses, so they are counted here."""
    sh = SHAPES[shape_name]
    b = sh.global_batch
    s = 1 if sh.kind == "decode" else sh.seq_len
    if s == 1:
        return 0.0  # decode path is a single recurrence step
    mult = 4.0 if sh.kind == "train" else 1.0  # fwd + remat-fwd + ~2x bwd
    total = 0.0
    for pos in range(cfg.period):
        kind = cfg.layer_kind(pos)["mixer"]
        if kind == "mamba":
            per_layer = 4.0 * b * s * cfg.d_inner * cfg.d_state  # update+cumprod
        elif kind == "rwkv":
            n = cfg.rwkv_head_dim
            per_layer = 6.0 * b * s * cfg.d_model * n  # H*N^2 state ops + cumprod
        else:
            continue
        total += per_layer * cfg.n_groups * mult
    return total


def analytic_memory_bytes(cfg, shape_name: str, mesh, fsdp: bool,
                          opt_bytes_per_param: int) -> dict:
    """Fusion-aware per-device HBM traffic model (bytes per step): weight
    shards, optimizer state, gradient traffic, remat boundaries, KV-cache
    reads and writes."""
    sh = SHAPES[shape_name]
    total, _ = lm.param_count(cfg)
    p_item = cfg.param_dtype.itemsize
    model_n = mesh.shape["model"]
    batch_n = math.prod(v for k, v in mesh.shape.items() if k != "model")
    chips = model_n * batch_n

    p_stream = total * p_item / model_n / (batch_n if fsdp else 1)  # local shard
    # weights move through each device once per pass whoever owns them
    w_pass = total * p_item / model_n / (1 if not fsdp else 1)

    b_local = sh.global_batch / batch_n if sh.global_batch % batch_n == 0 else sh.global_batch
    d = cfg.d_model
    act_item = cfg.compute_dtype.itemsize

    if sh.kind == "train":
        bound = cfg.n_groups * b_local * sh.seq_len * d * act_item  # remat carries
        opt = total * opt_bytes_per_param / model_n / (batch_n if fsdp else 1)
        grads = p_stream
        traffic = 3 * w_pass + 4 * opt + 2 * grads + 2 * bound
        traffic += b_local * sh.seq_len * 8  # tokens+labels
    elif sh.kind == "prefill":
        kv_cache = _cache_bytes(cfg, sh, chips)
        bound = cfg.n_groups * b_local * sh.seq_len * d * act_item
        traffic = w_pass + kv_cache + bound
    else:  # decode
        kv_cache = _cache_bytes(cfg, sh, chips)
        traffic = w_pass + kv_cache  # weights once + full cache read
    return {"per_device": float(traffic)}


def _cache_bytes(cfg, sh, chips) -> float:
    """Per-device bytes of the decode cache (sharded over all chips)."""
    act_item = cfg.compute_dtype.itemsize
    if cfg.kv_quant:
        # int8 planes + f32 per-(token,head) scales ~= 1 + 8/hd bytes/elem
        act_item = 1.0 + 8.0 / max(cfg.hd, 1)
    s = min(sh.seq_len, cfg.sliding_window) if cfg.sliding_window else sh.seq_len
    total = 0.0
    for pos in range(cfg.period):
        kind = cfg.layer_kind(pos)["mixer"]
        if kind == "attn":
            total += 2 * sh.global_batch * s * cfg.n_kv_heads * cfg.hd
        elif kind == "cross":
            total += 2 * sh.global_batch * cfg.n_img_tokens * cfg.n_kv_heads * cfg.hd
        elif kind == "mamba":
            total += sh.global_batch * cfg.d_inner * (cfg.d_state + cfg.d_conv - 1)
        elif kind == "rwkv":
            n = cfg.rwkv_head_dim
            total += sh.global_batch * cfg.d_model * (n + 2)
    return total * cfg.n_groups * act_item / chips


def bytes_per_device(tree, shardings) -> int:
    """The bytes one device holds of a tree placed by ``shardings``: each
    leaf's bytes over the product of the mesh axes its spec names."""
    leaves = [t for _, t in base.flatten(tree)]
    shards = [s for _, s in base.flatten(shardings)]
    assert len(leaves) == len(shards), (len(leaves), len(shards))
    out = 0
    for t, s in zip(leaves, shards):
        names = [n for e in s.spec if e is not None
                 for n in ((e,) if isinstance(e, str) else e)]
        out += t.numel() * t.element_size() // math.prod(s.mesh.shape[n] for n in names)
    return out


def cell_record(arch: str, shape_name: str, multi_pod: bool, fsdp=None) -> dict:
    """One cell's per-device bytes (by the shardings and by the analytic
    model) and its model FLOPs."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    total, _ = lm.param_count(cfg)
    fsdp = total >= FSDP_THRESHOLD if fsdp is None else fsdp
    args, shards = build_cell(cfg, shape_name, mesh, fsdp)
    per_arg = [bytes_per_device(a, s) for a, s in zip(args, shards)]
    opt_b = 8 if total < BF16_OPT_THRESHOLD else 4
    return {
        "arch": arch, "shape": shape_name, "mesh": "x".join(map(str, mesh.sizes)),
        "chips": math.prod(mesh.sizes), "fsdp": bool(fsdp),
        "param_bytes_per_device": per_arg[0],
        "state_and_input_bytes_per_device": sum(per_arg[1:]),
        "analytic_bytes_per_device": analytic_memory_bytes(cfg, shape_name, mesh, fsdp,
                                                           opt_b)["per_device"],
        "model_flops_global": model_flops(cfg, shape_name),
        "ssm_flops_global": ssm_correction_flops(cfg, shape_name),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="16x16", choices=["16x16", "2x16x16", "both"])
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    args = ap.parse_args(argv)
    archs = [a for a in ARCHS if a != "paper-nn"] if args.arch == "all" else [args.arch]
    pods = {"16x16": [False], "2x16x16": [True], "both": [False, True]}[args.mesh]
    fsdp = {"auto": None, "on": True, "off": False}[args.fsdp]
    for arch in archs:
        names = supported_shapes(arch) if args.shape == "all" else [args.shape]
        for shape_name in names:
            if shape_name not in supported_shapes(arch):
                print(f"SKIP {arch} x {shape_name} (not applicable)")
                continue
            for multi_pod in pods:
                print(json.dumps(cell_record(arch, shape_name, multi_pod, fsdp)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
