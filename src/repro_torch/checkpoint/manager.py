"""Atomic checkpoints with optional SECDED check planes.

Layout (one directory per step), the reference's:
    ckpt_dir/step_000123/
        manifest.json        # tree structure, shapes, dtypes, ecc flag
        leaf_00000.npy ...   # one file per tree leaf, in sorted-key order
        leaf_00000.ecc.npz   # (optional) the leaf's SECDED check plane
    ckpt_dir/LATEST          # text file with the newest step (atomic rename)

Leaves are visited as the reference's tree flattening visits them: dict
keys sorted, so {"params", "opt"} saves "opt" first and inside it "m",
"step", "v". A bf16 leaf, which has no numpy dtype, is stored as its raw
bits in uint16 and named "bfloat16" in the manifest's dtypes; its check
plane covers the same bytes.

With ``ecc_protect`` every leaf's raw bytes are cut into 64-bit words
(``quantize.array_to_words``) and encoded with Hsiao(72,64) on the leaf's
device (``kernels.ops.encode``: the kernel on the card). On load the words
are decoded on the device the leaf goes to (``ops.decode``): a single-bit
corruption is CORRECTED transparently, a multi-bit one is DETECTED and
raises ``CheckpointCorruption`` (the trainer then falls back to the
previous checkpoint) — the CORRECTED/DETECTED split of the BRAM
controller, applied to the long-lived memory of a training run.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import codes
from repro_torch.core import quantize
from repro_torch.kernels import ops as kops
from repro_torch.models import base


def _flatten(tree) -> list:
    return [leaf for _, leaf in base.flatten(tree)]


def _treedef(tree) -> str:
    """The tree's structure with ``*`` for each leaf (informational)."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as a numpy array (a bf16 leaf's bits as uint16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, tree, *, ecc_protect: bool = False, keep: int = 3):
    """Atomically write one checkpoint; prunes old ones beyond ``keep``.
    Leaves are tensors (numpy arrays are taken as CPU tensors)."""
    leaves = [torch.as_tensor(l) for l in _flatten(tree)]
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:06d}")
    final = os.path.join(ckpt_dir, f"step_{step:06d}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": _treedef(tree),
        "n_leaves": len(leaves),
        "ecc": ecc_protect,
        "dtypes": [_dtype_name(l) for l in leaves],
        "shapes": [list(l.shape) for l in leaves],
    }
    for i, leaf in enumerate(leaves):
        if ecc_protect:  # check bits on the leaf's device, queued before the copy
            lo, hi, nbytes = quantize.array_to_words(leaf)
            parity = kops.encode(lo, hi)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), _host_array(leaf))
        if ecc_protect:
            np.savez(os.path.join(tmp, f"leaf_{i:05d}.ecc.npz"),
                     parity=parity.cpu().numpy(), nbytes=nbytes)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    with open(os.path.join(ckpt_dir, ".LATEST_tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, ".LATEST_tmp"), os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep)


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:06d}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.startswith(".")
    ]


def latest_step(ckpt_dir: str):
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


class CheckpointCorruption(RuntimeError):
    """Raised when ECC DETECTS uncorrectable corruption in a leaf."""


def _verify_and_correct(t: torch.Tensor, eccf: str) -> torch.Tensor:
    """Decode the leaf's words against its stored check plane on the leaf's
    device: the leaf as it was saved, or ``CheckpointCorruption``."""
    z = np.load(eccf)
    nbytes = int(z["nbytes"])
    lo, hi, nb = quantize.array_to_words(t)
    assert nb == nbytes
    parity = torch.from_numpy(z["parity"]).to(t.device)
    lo2, hi2, status = kops.decode(lo, hi, parity)
    detected, corrected = torch.stack(
        [(status == codes.STATUS_DETECTED).sum(), (status == codes.STATUS_CORRECTED).sum()]
    ).tolist()
    if detected:
        raise CheckpointCorruption(f"{detected} uncorrectable words")
    if corrected:
        return quantize.words_to_array(lo2, hi2, nbytes, t.shape, t.dtype)
    return t


def _tensor_of(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if dtype_name == "bfloat16":  # raw bits (uint16 here, ml_dtypes' bfloat16 in the reference's)
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load(ckpt_dir: str, step: int, like, shardings=None):
    """Load into the structure of ``like``; each leaf goes to the device of
    the leaf of ``like`` it replaces (the CPU for a numpy leaf) and is
    verified there."""
    if shardings is not None:
        raise ValueError("resharding on load takes a device mesh, which the port does not "
                         "have yet (ROADMAP.md queue A item 10)")
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = _flatten(like)
    assert manifest["n_leaves"] == len(leaves_like), "tree structure mismatch"
    out = []
    for i, ref in enumerate(leaves_like):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        dev = ref.device if isinstance(ref, torch.Tensor) else torch.device("cpu")
        t = _tensor_of(arr, manifest["dtypes"][i]).to(dev)
        eccf = os.path.join(path, f"leaf_{i:05d}.ecc.npz")
        if manifest["ecc"] and os.path.exists(eccf):
            t = _verify_and_correct(t, eccf)
        out.append(t)
    return base.unflatten(like, out)
