"""The reliability layer's per-shard primitives, the collectives of a
``torch.distributed`` process group, and the int8-compressed gradient
all-reduce with error feedback as a data-parallel train step.

Each reliability shard draws its own fault population. Shard 0 keeps the
unsharded stream, the anchor that makes a one-shard mesh equal the
unsharded arena bit for bit; every other shard keys its stream with
``shard_seed``. The one cross-shard reduction is the sum of a stacked
per-shard counter block over its shard axis.

The compressed all-reduce sends each rank's gradient leaf as int8 and one
float32 scale (4x less traffic than float32); the quantisation residual is
kept in an error-feedback buffer, so the compression bias vanishes over
steps (EF-SGD). ``make_dp_compressed_train_step`` is the reference's
shard_map'd pure data-parallel step on a process group: params
replicated, each rank computing the loss and gradient of its contiguous
rows of the global batch. Its reduction is an all-gather of every rank's
int8 ``q`` and ``scale``, summed as ``q * scale`` in rank order on each
rank and divided by the rank count: the same bits on every backend and
every rank, and the reference's ``psum`` bit for bit at two ranks (a sum
of two floats does not depend on its order).

A tensor-parallel region of the training forward (``ModelAxis``) takes a
replicated input in through ``copy_in`` (identity forward, its gradient
summed over the "model" ranks backward) and sends its partial result out
through ``reduce_out`` (summed forward, identity backward), or its slices of
an activation out whole through ``ModelAxis.gather`` (an all-gather
forward, this rank's slice of the gradient backward); the sums are
``psum``'s, in rank order, so the result does not depend on timing and a
one-process emulation that adds the ranks' parts in the same order gives
the same bits.

Collectives move raw bytes (``all_gather``), so any dtype crosses any
backend. ``nccl`` takes one card per rank (it refuses two ranks on one
card: "Duplicate GPU detected"); ranks that share a card use ``gloo``,
whose group carries, once a buffer size, the CUDA IPC handles of each
rank's mailbox (a card buffer kept for the group's life) and after that
only barriers: every rank writes its payload into its mailbox and copies
the others' card to card. Where ``gloo`` ranks
sit on different cards, a CUDA payload is copied to the host for the
collective and back. Either way that is the transport: every operation on
a payload runs on the rank's device.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import reliability_axes
from repro_torch.models import base


def shard_index(coords: dict, mesh, axes=None) -> int:
    """Row-major linear shard index of the coordinates ``coords`` ({axis:
    index}) over ``axes`` (default: the mesh's reliability axes)."""
    axes = reliability_axes(mesh) if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes))
    shape = mesh.shape
    idx = 0
    for a in axes:
        idx = idx * shape[a] + int(coords[a])
    return idx


def shard_seed(seed: int, shard: int) -> int:
    """The field seed of shard ``shard``: shard 0 keeps ``seed``, every other
    shard keys its own stream."""
    return int(seed) if shard == 0 else int(seed) ^ (int(shard) << 32)


def shard_key(seed: int, coords: dict, mesh, axes=None) -> int:
    """The stream seed of the shard at ``coords``: ``seed`` on shard 0,
    ``shard_seed`` everywhere else, so no shard reproduces another's
    masks."""
    return shard_seed(seed, shard_index(coords, mesh, axes))


def psum_counters(counters: torch.Tensor) -> torch.Tensor:
    """Cross-shard reduction of a stacked (n_shards, ...) counter block: its
    sum over the shard axis."""
    return counters.sum(dim=0)


# -- collectives of a process group ---------------------------------------------
def all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` (one shape and dtype on every rank), in the
    group's rank order, on ``t``'s device. One rank gathers nothing.
    Treat the parts as read-only: this rank's may be ``t``'s own bytes."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return [t]
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    parts = None
    if raw.is_cuda and dist.get_backend(group) == "gloo":
        parts = _gather_on_one_card(raw, group)
        if parts is None:  # the ranks' cards differ: through the host
            out = [torch.empty_like(raw, device="cpu") for _ in range(n)]
            dist.all_gather(out, raw.cpu(), group=group)
            parts = [o.to(raw.device) for o in out]
    else:
        parts = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(parts, raw, group=group)
    return [p.view(t.dtype).reshape(t.shape) for p in parts]


class _Mailbox:
    """A rank's card buffer that its peers on the same card read through
    CUDA IPC, and its peers' buffers mapped into this process (None: the
    group's ranks do not share one card). Kept for the group's life, so a
    handle is exchanged and opened once a size, not once a call."""

    def __init__(self, group, nbytes: int, device):
        import socket

        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor

        self.group = group
        self.mine = torch.empty(nbytes, dtype=torch.uint8, device=device)
        me = (socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid))
        offers = [None] * dist.get_world_size(group)
        dist.all_gather_object(offers, (me, reduce_tensor(self.mine)), group=group)
        self.peers = None
        if all(where == me for where, _ in offers):
            rank = dist.get_rank(group)
            self.peers = [self.mine if i == rank else rebuild(*args)
                          for i, (_, (rebuild, args)) in enumerate(offers)]


_MAILBOXES: dict = {}


def _gather_on_one_card(raw: torch.Tensor, group):
    """Every rank's ``raw`` copied card to card through the ranks' mailboxes
    when all ranks of ``group`` share this rank's card (one host, one device
    UUID); None when they do not. Each rank writes its mailbox, and after a
    barrier copies every peer's; a second barrier keeps a rank from
    overwriting its mailbox before every peer has copied it. A mailbox grows
    (all ranks at once: the payloads have one size) to at least twice its
    size when a payload outgrows it."""
    import torch.distributed as dist

    box = _MAILBOXES.get(id(group))
    if box is None or box.group is not group or box.mine.device != raw.device:
        box = _MAILBOXES[id(group)] = _Mailbox(group, raw.numel(), raw.device)
    elif box.peers is not None and box.mine.numel() < raw.numel():
        del _MAILBOXES[id(group)]
        box = _MAILBOXES[id(group)] = _Mailbox(group, max(raw.numel(), 2 * box.mine.numel()),
                                               raw.device)
    if box.peers is None:
        return None
    n = raw.numel()
    stream = torch.cuda.current_stream(raw.device)
    box.mine[:n].copy_(raw)
    stream.synchronize()  # the payload is written before a peer reads it
    dist.barrier(group=group)
    mine = dist.get_rank(group)
    parts = [raw if i == mine else p[:n].clone() for i, p in enumerate(box.peers)]
    stream.synchronize()
    dist.barrier(group=group)  # no rank rewrites its mailbox before every peer copied it
    return parts


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, in rank order: the same bits on every
    rank, whatever the timing."""
    parts = all_gather(t, group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def pmax(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of every rank's ``t``."""
    parts = all_gather(t, group)
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out


def pmean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of every rank's ``t``: ``psum`` over the rank count."""
    import torch.distributed as dist

    return psum(t, group) / dist.get_world_size(group)


# -- the tensor-parallel region ----------------------------------------------------
class _CopyIn(torch.autograd.Function):
    """Into a tensor-parallel region: identity forward; backward, the sum
    over the group's ranks (in rank order) of their partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Out of a tensor-parallel region: forward, the sum over the group's
    ranks (in rank order) of their partial results; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _BatchMean(torch.autograd.Function):
    """A per-token mean over the data-parallel ranks' rows: forward, the
    mean of the ranks' means (equal row counts); backward, identity. Each
    rank's loss then holds the global statistic whole, so its gradient is
    the whole statistic's through this rank's rows, and the step's mean of
    the ranks' gradients is the global gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return pmean(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def batch_mean(x: torch.Tensor, group) -> torch.Tensor:
    """``_BatchMean`` of ``x`` over ``group`` (None: ``x``, the process
    holds every row)."""
    return x if group is None else _BatchMean.apply(x, group)


class _Fanout(torch.autograd.Function):
    """The emulation's copy into a region: one copy a rank; backward, the
    copies' gradients summed in rank order, as ``_CopyIn`` sums them."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.clone() for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0]
        for g in grads[1:]:
            total = total + g
        return total, None


class _GatherOut(torch.autograd.Function):
    """Activation slices out of a tensor-parallel region, whole: forward,
    every rank's slice concatenated along ``dim`` in rank order; backward,
    this rank's slice of the gradient (the gathered tensor is read whole,
    outside a region, so its gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.dim, ctx.size, ctx.rank = dim, x.shape[dim], dist.get_rank(group)
        out = torch.cat(all_gather(x, group), dim=dim)
        _ACTIVATION_BYTES[0] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


# bytes of activations gathered over "model" since the last reset
# (``activation_gathered_bytes``), apart from the weights that
# ``sharding.gathered_bytes`` counts
_ACTIVATION_BYTES = [0]


def activation_gathered_bytes() -> int:
    """The bytes of the tensors that ``ModelAxis.gather`` has returned on
    a mesh since the last reset (a remat recompute gathers again)."""
    return _ACTIVATION_BYTES[0]


def reset_activation_gathered_bytes() -> None:
    _ACTIVATION_BYTES[0] = 0


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a tensor-parallel region of ``group``'s ranks."""
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's partial ``x`` leaving a tensor-parallel
    region of ``group``'s ranks."""
    return _ReduceOut.apply(x, group)


class ModelAxis:
    """The "model" axis of a tensor-parallel forward (``lm.train_loss(...,
    model=)``): its size ``n`` and the ranks along it whose shards this
    process computes (``ranks``). A sharded region takes one branch a rank
    of ``ranks``, each with that rank's local shards: ``enter`` gives each
    branch its copy of a replicated input, ``leave`` sums the branches'
    partial results over the axis, ``max`` takes their maximum, ``gather``
    concatenates their slices of an activation.

    On a mesh (``of_mesh``) a process computes its own rank's branch and
    the branches meet in collectives over the mesh's model group
    (``copy_in``, ``reduce_out``, ``pmax``, an all-gather). The one-process emulation
    (``emulated``) computes every rank's branch in turn and adds their
    results in rank order, the same operations the collectives run, so the
    two give the same bits. Every rank runs the same collectives in the same
    order, also in a remat recompute, which replays the forward's.

    ``batch`` is the group of the data-parallel ranks whose rows make up
    the global batch beside this one (None: the process holds every row):
    the MoE's load-balancing statistics are means over it
    (``batch_mean``), as the reference computes them over the global
    batch."""

    def __init__(self, n: int, ranks: tuple, group=None, batch=None):
        self.n, self.ranks, self.group, self.batch = int(n), tuple(ranks), group, batch
        if group is None and self.ranks != tuple(range(self.n)):
            raise ValueError(f"an emulated axis computes all {n} ranks, not {ranks}")

    @classmethod
    def of_mesh(cls, mesh, split_batch: bool = False) -> "ModelAxis":
        """This rank's branch on a ``launch.mesh.HostMesh``; with
        ``split_batch`` its rows are its share of a batch split over the
        batch axes."""
        return cls(mesh.n_model, (mesh.model_index,), mesh.model_group,
                   mesh.batch_group if split_batch else None)

    @classmethod
    def emulated(cls, n: int) -> "ModelAxis":
        """Every one of ``n`` ranks' branches, in one process."""
        return cls(n, tuple(range(n)))

    def enter(self, x: torch.Tensor) -> list:
        if self.group is None:
            return list(_Fanout.apply(x, self.n))
        return [copy_in(x, self.group)]

    def leave(self, parts: list) -> torch.Tensor:
        if self.group is None:
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total
        return reduce_out(parts[0], self.group)

    def gather(self, parts: list, dim: int) -> torch.Tensor:
        """The branches' activation slices concatenated along ``dim`` in
        rank order, whole on every rank (an all-gather over the axis; the
        emulation's ``torch.cat``). Backward, each branch takes its own
        slice of the gradient: the result must be read outside a region,
        where every rank computes the same (enter it again to read it
        inside one). It moves activations, never weights."""
        if self.group is None:
            return torch.cat(parts, dim=dim)
        return _GatherOut.apply(parts[0], self.group, dim % parts[0].dim())

    def max(self, parts: list) -> torch.Tensor:
        """The maximum over the axis (no gradient)."""
        parts = [p.detach() for p in parts]
        if self.group is None:
            out = parts[0]
            for p in parts[1:]:
                out = torch.maximum(out, p)
            return out
        return pmax(parts[0], self.group)


def local_rows(batch: dict, index: int, n: int) -> dict:
    """Rows [index * B / n, (index + 1) * B / n) of every (B, ...) leaf of a
    batch: a data-parallel rank's contiguous slice of the global batch."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % n:
            raise ValueError(f"batch leaf {k!r} of {b} rows does not split over {n} ranks")
        out[k] = v[index * (b // n):(index + 1) * (b // n)]
    return out


# -- the int8-compressed data-parallel step --------------------------------------
def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns (q, scale), scale = max(max|x|,
    1e-12) / 127 and q = round-half-to-even(x / scale) clipped to +-127,
    each operation rounded as the reference's operations are one by one.
    (A compiled reference program may rewrite the division by 127 as a
    product with its reciprocal, and fuse ``compressed_psum``'s product and
    difference, which moves a scale or a residual by a last bit.)"""
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _ef_int8(g: torch.Tensor, ef: torch.Tensor):
    """(q, scale, sent, new_ef) of one leaf: the int8 payload of ``g`` plus
    its error feedback, its float32 value and the residual kept back."""
    target = g.to(torch.float32) + ef
    q, scale = quantize_int8(target)
    sent = q.to(torch.float32) * scale
    return q, scale, sent, target - sent


def compressed_psum(g: torch.Tensor, ef: torch.Tensor, group=None):
    """Error-feedback int8 mean of one gradient leaf over the ranks of
    ``group``: the int8 payload and its scale are what cross the links.
    Returns (g_avg, new_ef), both float32."""
    import torch.distributed as dist

    q, scale, sent, new_ef = _ef_int8(g, ef)
    qs, scales = all_gather(q, group), all_gather(scale, group)
    total = sent if len(qs) == 1 else qs[0].to(torch.float32) * scales[0]
    for q_r, s_r in zip(qs[1:], scales[1:]):
        total = total + q_r.to(torch.float32) * s_r
    return total / dist.get_world_size(group), new_ef


def init_error_feedback(params):
    """A zero float32 buffer beside every parameter leaf."""
    return base.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def dp_loss_and_grads(loss_fn, tcfg, params, batch, group, index: int, n: int, ef=None):
    """This rank's part of a data-parallel step over the ``n`` ranks of
    ``group``, this rank the ``index``-th: the loss, metrics and gradients
    of its contiguous rows of ``batch`` on ``params``
    (``train_step._loss_and_grads``), each averaged over the group in rank
    order, the gradient leaves int8 with error feedback where ``ef`` is
    given, else plain in their dtype.

    A batch whose rows do not split over ``n`` is computed whole on every
    rank and no collective runs (its gradients are then the same on every
    rank): the reference's ``data_sharding`` replicates such a batch.
    Returns (loss, metrics, grads, ef), ``ef`` updated (None without)."""
    from repro_torch.train.train_step import _loss_and_grads

    b = next(iter(batch.values())).shape[0]
    split = n > 1 and b % n == 0
    local = local_rows(batch, index, n) if split else batch
    loss, metrics, grads = _loss_and_grads(loss_fn, tcfg, params, local)
    if split:
        loss = pmean(loss, group)
        metrics = {k: pmean(v, group) if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
    flat = base.flatten(grads)
    if ef is not None:
        pairs = [compressed_psum(g, e, group) if split else _ef_int8(g, e)[2:]
                 for (_, g), (_, e) in zip(flat, base.flatten(ef))]
        grads = base.unflatten(grads, [a for a, _ in pairs])
        ef = base.unflatten(grads, [e for _, e in pairs])
    elif split:
        grads = base.unflatten(grads, [pmean(g, group) for _, g in flat])
    return loss, metrics, grads, ef


def make_dp_compressed_train_step(cfg, tcfg, mesh, axis: str = "data", compress: bool = True):
    """Pure data-parallel train step on ``mesh`` (a ``launch.mesh.HostMesh``):
    params replicated, the global batch split over ``axis`` by rows,
    gradients averaged int8 + error feedback (``compress``) or plain
    (``dp_loss_and_grads``).

    Returns fn(params, opt_state, ef, batch) -> (params, opt_state, ef,
    loss); every rank passes the same global batch and keeps its own
    error feedback."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_loss_fn

    loss_fn = make_loss_fn(cfg, tcfg)
    group = mesh.device_mesh.get_group(axis)
    i = mesh.axis_names.index(axis)

    def step(params, opt_state, ef, batch):
        loss, _, grads, new_ef = dp_loss_and_grads(loss_fn, tcfg, params, batch, group,
                                                   mesh.coordinate[i], mesh.sizes[i],
                                                   ef if compress else None)
        new_params, new_opt, _ = adamw.update(grads, opt_state, params, tcfg.optimizer)
        return new_params, new_opt, ef if new_ef is None else new_ef, loss

    return step
