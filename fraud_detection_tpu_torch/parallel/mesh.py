"""Device meshes and row sharding in torch terms — twin of
``fraud_detection_tpu/parallel/mesh.py``.

The reference names two axes on a ``jax.sharding.Mesh``:

  axis "data"    — rows (dialogues): data parallelism for training and for
                   streaming micro-batches; gradient and histogram
                   reductions are sums over this axis (the Rabit-allreduce
                   analogue);
  axis "feature" — the TF-IDF feature dimension.

Here a :class:`Mesh` is a grid of this process's ``torch.device`` s with
one name per axis — (data, feature) by default; the explanation LLM's
meshes name ("data", "model"), ("data", "seq"), ("model",), ("seq",) or
("data",), as ``models/llm.py`` and ``models/train_llm.py`` read them — and
a ``shape``, and — when a ``torch.distributed`` process group spans
several processes — the global axis sizes (the first axis spans the
processes), this process's rank and the group. One process holds one
replica of a model per device of its grid; a row shard lives on the
device of its data index (the first column of the grid). What JAX's
partitioner does for a sharded array is done by hand:

* :func:`shard_rows` pads rows to a data-axis multiple with zero rows and
  places each shard on its device (:class:`ShardedRows`);
* :func:`data_sum` is the port's ``psum``: it adds the local shards' tensors
  on the mesh's first device in a fixed device order, then ``all_reduce`` s
  the sum across processes when a group exists. Linear and tree training
  reduce through it; serving needs no reduction (rows score alone) and
  reads its shards' results back in row order;
* the explanation LLM's programs, run by every process of a mesh at once
  (one process per card), move tensors across processes with collectives
  that carry their gradients: :func:`sum_across` (the row-parallel sum),
  :func:`grad_sum_across` (its mirror, for a replicated input to each
  process's share of the work), :func:`gather_across`,
  :func:`all_to_all_across`, :func:`ring_shift`, and
  :func:`sum_in_rank_order` for the data rows' gradients. Within
  :func:`collective_order` (which ``llm.forward`` and the LLM trainer's
  step open) their backwards run in one order on every process.

A grid may name one device several times (``make_mesh(devices=
[torch.device("cpu")] * 8)``, ``["cuda:0"] * 4``): the shards then run one
after another on that device. This is the port's stand-in for XLA's
``--xla_force_host_platform_device_count=8`` virtual CPU devices, and lets
the shard logic run where one device exists. The CLIs never build such a
grid: they take every local device, as the reference does.
"""

from __future__ import annotations

import contextvars
import os
import socket
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fraud_detection_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


class Mesh:
    """A grid of this process's devices with one name per axis.

    ``devices`` is the local object array of ``torch.device`` (device-likes
    such as ``"cpu"`` are resolved), one array dimension per name of
    ``axis_names`` (default ``("data", "feature")``); ``shape`` maps each
    axis name to its GLOBAL size (the first axis spans ``process_count``
    processes of equal grids, process-major, as ``jax.devices()`` orders a
    multi-process mesh)."""

    def __init__(self, devices, axis_names: Sequence[str] = (DATA_AXIS,
                                                            FEATURE_AXIS),
                 *, process_count: int = 1, process_index: int = 0,
                 group=None):
        names = tuple(axis_names)
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(names) or grid.size == 0 or \
                len(set(names)) != len(names):
            raise ValueError(f"mesh grid must be a non-empty array with one "
                             f"dimension per axis name {names}, got shape "
                             f"{grid.shape}")
        resolved = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            resolved[idx] = d if isinstance(d, torch.device) \
                else resolve_device(d)
        self.devices = resolved
        self.axis_names = names
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        self.group = group

    @property
    def shape(self) -> dict:
        return {name: n * (self.process_count if i == 0 else 1)
                for i, (name, n) in enumerate(zip(self.axis_names,
                                                  self.devices.shape))}

    def local_size(self, axis: str) -> int:
        """The axis' size in this process's grid (1 where it is absent)."""
        if axis not in self.axis_names:
            return 1
        return self.devices.shape[self.axis_names.index(axis)]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis, in
        axis order ([home] where the axis is absent)."""
        if axis not in self.axis_names:
            return [self.home]
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for j in range(self.devices.shape[i]):
            idx[i] = j
            out.append(self.devices[tuple(idx)])
        return out

    def take(self, axis: str, index: int) -> "Mesh":
        """The sub-mesh at local ``index`` of ``axis`` (the other axes, this
        process only): a data row of a (data, model) or (data, seq) mesh."""
        i = self.axis_names.index(axis)
        names = self.axis_names[:i] + self.axis_names[i + 1:]
        return Mesh(np.take(self.devices, index, axis=i), names)

    @property
    def local_data_parallel(self) -> int:
        return self.local_size(DATA_AXIS)

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each local data index, in data order."""
        return self.axis_devices(DATA_AXIS)

    @property
    def home(self) -> torch.device:
        """Where reductions land: the first local device."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}, "
                f"process {self.process_index}/{self.process_count})")


class Sharding(NamedTuple):
    """A placement: the mesh and one axis name (or None) per array
    dimension, the reference's ``NamedSharding(mesh, PartitionSpec(...))``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """Every device of ``device_type`` this process may use: the visible
    CUDA devices (under a multi-process group with ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` set, this process's share of them), or the CPU.
    CUDA asked for and absent raises."""
    dev = resolve_device(device_type)
    if dev.type != "cuda":
        return [torch.device(dev.type)]
    ids = list(range(torch.cuda.device_count()))
    if (_group_size() > 1 and "LOCAL_RANK" in os.environ
            and "LOCAL_WORLD_SIZE" in os.environ):
        lr, lw = int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
        ids = [i for i in ids if i % lw == lr]
    return [torch.device("cuda", i) for i in ids]


def _group_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _grid(devs: Sequence[torch.device], data_parallel: Optional[int],
          feature_parallel: int) -> np.ndarray:
    n = len(devs)
    if data_parallel is None:
        if n % feature_parallel:
            raise ValueError(f"{n} devices not divisible by "
                             f"feature_parallel={feature_parallel}")
        data_parallel = n // feature_parallel
    if data_parallel * feature_parallel != n:
        raise ValueError(f"data_parallel({data_parallel}) * "
                         f"feature_parallel({feature_parallel}) != {n}")
    grid = np.empty((data_parallel, feature_parallel), dtype=object)
    for i, d in enumerate(devs):
        grid[i // feature_parallel, i % feature_parallel] = d
    return grid


def _as_devices(devices) -> List[torch.device]:
    return [resolve_device(d) for d in devices]


def make_mesh(n_devices: Optional[int] = None,
              data_parallel: Optional[int] = None,
              feature_parallel: int = 1,
              devices: Optional[Sequence] = None, *,
              device_type: str = "cuda") -> Mesh:
    """A (data, feature) mesh over ``devices`` (default: every local device
    of ``device_type``), all on the data axis unless ``feature_parallel``
    says otherwise — the layout for this workload, where models are small
    and rows plentiful. Under a multi-process group the default mesh spans
    every process (each contributes its local grid)."""
    devs = (_as_devices(devices) if devices is not None
            else local_devices(device_type))
    if n_devices is not None:
        devs = devs[:n_devices]
    grid = _grid(devs, data_parallel, feature_parallel)
    if devices is None and _group_size() > 1:
        dist = torch.distributed
        return Mesh(grid, process_count=dist.get_world_size(),
                    process_index=dist.get_rank(), group=dist.group.WORLD)
    return Mesh(grid)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Rows sharded over the data axis, features replicated."""
    return Sharding(mesh, (DATA_AXIS, None))


def feature_sharding(mesh: Mesh) -> Sharding:
    """The feature dimension of a (B, F) array sharded."""
    return Sharding(mesh, (None, FEATURE_AXIS))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class ShardedRows:
    """A row-sharded array: this process's shards, each on its data
    device, in data order; ``shape`` is the GLOBAL (padded) shape."""

    shards: List[torch.Tensor]
    shape: Tuple[int, ...]
    mesh: Mesh

    def gather(self) -> torch.Tensor:
        """The whole array on the mesh's first device (every process's
        shards, in row order)."""
        local = torch.cat([s.to(self.mesh.home) for s in self.shards])
        if self.mesh.process_count == 1:
            return local
        parts = [torch.empty_like(local) for _ in range(self.mesh.process_count)]
        torch.distributed.all_gather(parts, local, group=self.mesh.group)
        return torch.cat(parts)


def _split_local(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """This process's data-axis shards of the global rows ``x`` (rows a
    multiple of the global data size), each copied to its device."""
    dp = mesh.shape[DATA_AXIS]
    per = x.shape[0] // dp
    first = mesh.process_index * mesh.local_data_parallel
    return [x[(first + i) * per:(first + i + 1) * per].to(d, non_blocking=True)
            for i, d in enumerate(mesh.data_devices)]


def shard_rows(x, mesh: Mesh) -> ShardedRows:
    """Pad rows to a data-axis multiple and place one shard per data device.

    Padding rows are zeros; callers carry an explicit validity mask (or
    weight 0) where padded rows must not count (losses, histograms)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    dp = mesh.shape[DATA_AXIS]
    padded = pad_to_multiple(t.shape[0], dp)
    if padded != t.shape[0]:
        t = torch.cat([t, t.new_zeros((padded - t.shape[0], *t.shape[1:]))])
    return ShardedRows(_split_local(t, mesh), tuple(t.shape), mesh)


def data_sum(tensors: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The data-axis reduction (the reference's ``psum`` over "data"): the
    local shards' tensors added on the mesh's first device in data order
    (((s0 + s1) + s2) + ...), then summed across processes with
    ``all_reduce`` when the mesh spans a process group. Every process gets
    the same sum."""
    home = mesh.home
    total = tensors[0].to(home)
    for t in tensors[1:]:
        total = total + t.to(home)
    if mesh.process_count > 1:
        total = total.contiguous()
        torch.distributed.all_reduce(total, group=mesh.group)
    return total


def replicate(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``t`` on every local data device (one copy per distinct device)."""
    copies = {}
    return [copies.setdefault(d, t.to(d)) for d in mesh.data_devices]


# ---------------------------------------------------------------------------
# Multi-process support (torch.distributed)
# ---------------------------------------------------------------------------

def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           timeout_s: float = 120.0) -> bool:
    """Multi-process bootstrap over ``torch.distributed``: ``gloo`` on the
    CPU, ``nccl`` on the card.

    Reads the environment ``torchrun`` sets when arguments are omitted:
    ``MASTER_ADDR``:``MASTER_PORT`` stands for the reference's
    ``JAX_COORDINATOR_ADDRESS``, ``WORLD_SIZE`` for ``JAX_NUM_PROCESSES``
    and ``RANK`` for ``JAX_PROCESS_ID``. A no-op returning False when the
    job is single-process (no address, or one process), so single-process
    paths never pay for it. torch has no rank auto-detection, so a
    multi-process job without a rank raises."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes is None \
            or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process job needs its rank (RANK or "
                         "process_id)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local_rank % max(1, torch.cuda.device_count()))
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s))
    return True


def _granules(n_local: int) -> List[Tuple[str, int]]:
    """(host, local device count) of every rank, in rank order."""
    mine = (socket.gethostname(), n_local)
    if _group_size() == 1:
        return [mine]
    out: list = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, mine)
    return out


def make_hybrid_mesh(feature_parallel: int = 1, *,
                     devices: Optional[Sequence] = None,
                     device_type: str = "cuda") -> Mesh:
    """A (data, feature) mesh over every process's devices, laid out for the
    links between them: the data axis spans the slowest link (its sums are
    one small histogram or gradient a step), and the feature axis stays
    inside a granule, a host whose devices share its fast links.

    Granules are hosts, not processes: several processes on one host are
    one granule and make the plain global mesh. Sizing the cross-process
    axis by the process count is the mistake the reference's 2-process test
    caught; here it would refuse a feature axis that fits a host. Several
    granules must hold equal device counts. ``devices`` names this
    process's devices (default: every local device of ``device_type``)."""
    devs = (_as_devices(devices) if devices is not None
            else local_devices(device_type))
    ranks = _granules(len(devs))
    hosts: dict = {}
    for host, n in ranks:
        hosts[host] = hosts.get(host, 0) + n
    if len({n for _, n in ranks}) != 1:
        raise ValueError(f"uneven per-process device counts: "
                         f"{sorted({n for _, n in ranks})}")
    if len(hosts) > 1 and len(set(hosts.values())) != 1:
        raise ValueError(f"uneven device granules: {sorted(set(hosts.values()))}")
    per_granule = next(iter(hosts.values()))
    if per_granule % feature_parallel or len(devs) % feature_parallel:
        raise ValueError(
            f"{per_granule} per-granule devices not divisible by "
            f"feature_parallel={feature_parallel}")
    grid = _grid(devs, None, feature_parallel)
    if len(ranks) == 1:
        return Mesh(grid)
    dist = torch.distributed
    return Mesh(grid, process_count=dist.get_world_size(),
                process_index=dist.get_rank(), group=dist.group.WORLD)


# ---------------------------------------------------------------------------
# Collectives with gradients over ``mesh.group``: an axis across processes
#
# In one process a tensor moves between devices by ``.to()``, which autograd
# differentiates. Across processes the model's programs run on every
# process at once, each holding the same replicated activations and
# computing the same loss, and these functions carry the gradient over the
# process boundary. Each is the identity where the mesh holds one process.
# ---------------------------------------------------------------------------

def spans(mesh: Mesh, axis: str) -> bool:
    """Whether ``axis`` is the mesh's axis across processes (its first)."""
    return mesh.process_count > 1 and mesh.axis_names[0] == axis


# The order of the backwards. Autograd runs a backward node on a thread of
# the device its gradient lies on, one thread a device, so where a process
# holds several devices two collectives' backwards become ready in an order
# set by timing, which may differ between processes: a backward collective
# that two processes post in different orders pairs one tensor's gradient
# with another's, or hangs where their sizes differ. So each collective
# below takes an order token (or None) and returns a fresh one beside its
# result: within ``collective_order()`` every collective feeds the next
# one's token, and autograd can run their backwards only in the reverse of
# the order they ran in, the same order on every process.

_CHAIN: contextvars.ContextVar = contextvars.ContextVar("collective_chain",
                                                        default=None)


@contextmanager
def collective_order():
    """Chain the collectives with gradients that run inside into one order
    (the chain's token lives in a context variable: one chain a thread).
    Where a chain is already open, its collectives join it: a step that
    runs several forwards before one backward opens it around them all.
    Costs a scalar copy a collective, and nothing where autograd does not
    record or the mesh holds one process."""
    if _CHAIN.get() is not None:
        yield
        return
    reset = _CHAIN.set([None])
    try:
        yield
    finally:
        _CHAIN.reset(reset)


def _token(token):
    return None if token is None else token.clone()


class _SumAcross(torch.autograd.Function):
    """All-reduce; backward the identity: every process holds the sum and
    computes the same loss from it, so each already has the sum's whole
    gradient, which is each addend's."""

    @staticmethod
    def forward(ctx, t, token, group):
        out = t.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out, _token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        return g, g_token, None


class _GradSumAcross(torch.autograd.Function):
    """The identity; backward all-reduces: a replicated tensor that each
    process feeds to its own share of the work gets a partial gradient on
    each, and the whole gradient is their sum."""

    @staticmethod
    def forward(ctx, t, token, group):
        ctx.group = group
        return t.view_as(t), _token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, g_token, None


class _GatherAcross(torch.autograd.Function):
    """Every process's block concatenated along ``dim`` in rank order;
    backward takes this process's slice of the gradient (each process holds
    the whole gradient of the replicated result)."""

    @staticmethod
    def forward(ctx, t, token, dim, mesh):
        ctx.dim, ctx.rank, ctx.size = dim, mesh.process_index, t.shape[dim]
        t = t.contiguous()
        got = [torch.empty_like(t) for _ in range(mesh.process_count)]
        torch.distributed.all_gather(got, t, group=mesh.group)
        return torch.cat(got, dim=dim), _token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), g_token,
                None, None)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    torch.distributed.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 (one entry a process): entry p goes
    to process p, which puts it at this process's index. Applied twice it
    returns every entry home, so its backward is itself."""

    @staticmethod
    def forward(ctx, t, token, group):
        ctx.group = group
        return _all_to_all(t, group), _token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        return _all_to_all(g, ctx.group), g_token, None


def _shift(t: torch.Tensor, out: torch.Tensor, mesh: Mesh, step: int):
    """Send ``t`` to rank + step and receive ``out`` from rank - step, as
    one batch: NCCL runs a lone send only once its peer's matching receive
    is posted, which would wait behind the peer's own send."""
    dist = torch.distributed
    rank, count = mesh.process_index, mesh.process_count
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t.contiguous(), (rank + step) % count,
                       mesh.group),
            dist.P2POp(dist.irecv, out, (rank - step) % count, mesh.group)]):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One step of a ring across processes: this process's block goes to
    the next rank and the previous rank's arrives on ``device``; backward
    is the reverse rotation. Both travel through the mesh's first device,
    the one NCCL binds the process to."""

    @staticmethod
    def forward(ctx, t, token, device, mesh):
        ctx.mesh, ctx.device = mesh, t.device
        t = t.to(mesh.home)
        return (_shift(t, t.new_empty(t.shape), mesh, 1).to(device),
                _token(token))

    @staticmethod
    def backward(ctx, g, g_token):
        g = g.to(ctx.mesh.home)
        return (_shift(g, g.new_empty(g.shape), ctx.mesh, -1).to(ctx.device),
                g_token, None, None)


def _ordered(fn, mesh: Mesh, t: torch.Tensor, *args) -> torch.Tensor:
    """``fn.apply`` on ``t``, in the open chain (``collective_order``)
    where autograd records."""
    chain = _CHAIN.get() if torch.is_grad_enabled() else None
    if chain is None:
        return fn.apply(t, None, *args)[0]
    if chain[0] is None:
        chain[0] = torch.zeros((), device=mesh.home, requires_grad=True)
    out, chain[0] = fn.apply(t, chain[0], *args)
    return out


def sum_across(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the mesh's processes (``_SumAcross``)."""
    if mesh.process_count == 1:
        return t
    return _ordered(_SumAcross, mesh, t, mesh.group)


def grad_sum_across(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` as it is, its gradient summed over the processes
    (``_GradSumAcross``)."""
    if mesh.process_count == 1:
        return t
    return _ordered(_GradSumAcross, mesh, t, mesh.group)


def gather_across(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """Every process's ``t`` concatenated along ``dim`` in rank order
    (``_GatherAcross``)."""
    if mesh.process_count == 1:
        return t
    return _ordered(_GatherAcross, mesh, t, dim, mesh)


def all_to_all_across(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Entry p of ``t``'s dim 0 (of size ``process_count``) sent to process
    p, entry p of the result received from it (``_AllToAll``)."""
    if mesh.process_count == 1:
        return t
    return _ordered(_AllToAll, mesh, t, mesh.group)


def ring_shift(t: torch.Tensor, device, mesh: Mesh) -> torch.Tensor:
    """``t`` passed to the next process around the ring, the previous
    one's received on ``device`` (``_RingShift``)."""
    if mesh.process_count == 1:
        return t.to(device)
    return _ordered(_RingShift, mesh, t, device, mesh)


# sum_in_rank_order's bucket: the elements summed by one exchange, so its
# transients (the bucket, what arrives and the sum) stay three buckets'
# bytes whatever the model's size and the processes' count
SUM_BUCKET = 1 << 26


def _sum_bucket(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``flat`` (n,) summed over the processes in rank order at an
    all-reduce's traffic: an all-to-all hands process p every process's
    p-th chunk, p adds them ((c_0 + c_1) + c_2) + ..., and an all-gather
    returns every chunk's sum to every process."""
    count, n = mesh.process_count, flat.numel()
    chunk = -(-n // count)
    padded = torch.zeros(chunk * count, dtype=flat.dtype, device=flat.device)
    padded[:n] = flat
    got = torch.empty_like(padded)
    torch.distributed.all_to_all_single(got, padded, group=mesh.group)
    got = got.view(count, chunk)
    total = got[0]
    for c in got[1:]:
        total = total + c
    sums = [torch.empty_like(total) for _ in range(count)]
    torch.distributed.all_gather(sums, total, group=mesh.group)
    return torch.cat(sums)[:n]


def sum_in_rank_order(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor replaced, in place, by its sum over the mesh's processes
    as ((t_0 + t_1) + t_2) + ..., ``t_r`` rank r's: the same bits on every
    process, whatever order an all-reduce would add in. The tensors of a
    dtype go flattened together on the mesh's first device, in buckets of
    at most SUM_BUCKET elements (a tensor larger than that is a bucket of
    its own), so the sums take a few buckets' bytes beside the tensors."""
    if mesh.process_count == 1:
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        buckets, size = [[]], 0
        for t in group:
            if buckets[-1] and size + t.numel() > SUM_BUCKET:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += t.numel()
        for bucket in buckets:
            total = _sum_bucket(torch.cat([t.reshape(-1).to(mesh.home)
                                           for t in bucket]), mesh)
            offset = 0
            for t in bucket:
                t.copy_(total[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def global_batch_from_local(x_local, mesh: Mesh) -> ShardedRows:
    """Per-process rows -> the global row set, sharded over the data axis.

    Each process feeds only the rows it loaded (e.g. from its own Kafka
    partitions); the result is the concatenated global batch in process
    order, this process's part split over its data devices. Local row
    counts must be equal across processes and divide by the local data
    axis (pad with zero rows and a validity mask as in ``shard_rows``)."""
    t = (x_local if isinstance(x_local, torch.Tensor)
         else torch.from_numpy(np.asarray(x_local)))
    local_dp = mesh.local_data_parallel
    if t.shape[0] % local_dp:
        raise ValueError(f"{t.shape[0]} local rows do not divide over "
                         f"{local_dp} local data devices")
    per = t.shape[0] // local_dp
    shards = [t[i * per:(i + 1) * per].to(d, non_blocking=True)
              for i, d in enumerate(mesh.data_devices)]
    return ShardedRows(shards, (t.shape[0] * mesh.process_count,
                                *t.shape[1:]), mesh)
