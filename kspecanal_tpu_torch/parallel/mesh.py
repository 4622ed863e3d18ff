"""Process mesh of the sharded pipeline — the port of
``kspecanal_tpu.parallel.mesh`` on ``torch.distributed``.

One process per rank, and a ``DeviceMesh`` with the dims ``("time",
"band")`` as the counterpart of the JAX ``Mesh``:

  * ``time`` — contiguous IQ time-blocks (sequence parallel; windows that
    straddle a block boundary get their overlap samples from the right
    neighbour by a ring shift, the halo exchange);
  * ``band`` — scan-mode sub-bands (each rank owns a set of retune bands,
    stitched after an all-gather).

The JAX package runs one program over the mesh (``shard_map``); here every
rank runs the same Python and the collectives meet in the process groups
of the mesh's dims.  Rank 0 alone owns the IQ source: :func:`scatter_rows`
hands every rank its slice.  Ranks are laid out as
``rank = time_index * band + band_index``.

The collectives of the sharded modules live here, so each backend detail
lives in one place: NCCL between cards, gloo on the CPU.  Ranks may share
one card over gloo (``make_mesh(..., share_card=True)``, asked for
explicitly); gloo carries CUDA tensors for some collectives only, so in
that mode every collective copies its payload through the host.

    torchrun --nproc-per-node N -m kspecanal_tpu_torch zeroSpan ... \\
        tpuMeshTime N
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from kspecanal_tpu_torch.config import CUMU_AVG, CUMU_MAX, CUMU_MIN, CUMU_RAW

AXES = ("time", "band")
LAUNCH = "torchrun --nproc-per-node N -m kspecanal_tpu_torch"
TIMEOUT_S = 600.0   # a hung collective fails after this long

_REDUCE_OPS = {CUMU_AVG: dist.ReduceOp.SUM, CUMU_RAW: dist.ReduceOp.SUM,
               CUMU_MAX: dist.ReduceOp.MAX, CUMU_MIN: dist.ReduceOp.MIN}
# dtypes a row scatter carries, by the code in its header
_DTYPES = (torch.float32, torch.uint8)
_HEADER_TENSORS = 3   # at most this many tensors, of at most 2 dims, a call


class NoWorldError(RuntimeError):
    """A mesh was asked for in a process that no launcher started."""


def init_distributed(backend: Optional[str] = None, *,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> None:
    """Join the world: ``init_process_group`` from the torchrun
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``...; multi-node
    included), or from ``init_method``/``world_size``/``rank`` where the
    caller launched the ranks itself.  The backend is NCCL where CUDA
    exists, else gloo.  A no-op if the world is already initialized;
    raises, naming torchrun, where no world was launched."""
    if dist.is_initialized():
        return
    if init_method is None and "WORLD_SIZE" not in os.environ:
        raise NoWorldError(f"no launched world: start the ranks with "
                           f"'{LAUNCH} ... tpuMeshTime N'")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(time: int = 1, band: int = 1, *, device_type: str = "cuda",
              share_card: bool = False) -> DeviceMesh:
    """The ``(time, band)`` mesh over the whole world, after
    :func:`init_distributed`.  Each rank's device is ``cuda:LOCAL_RANK``.
    Raises where the world does not hold the mesh, and where a node has
    more ranks than cards, as JAX refuses more mesh slots than devices,
    unless ``share_card`` asks for ranks sharing a card (gloo only: NCCL
    refuses two ranks on one card)."""
    need, world = time * band, dist.get_world_size()
    if need != world:
        raise ValueError(f"mesh {time}x{band} needs {need} ranks, the "
                         f"world has {world}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        on_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if on_node > cards:
            if not share_card:
                raise ValueError(
                    f"{on_node} ranks on this node and {cards} CUDA "
                    f"card(s): start at most one rank a card")
            if dist.get_backend() == "nccl":
                raise ValueError("NCCL refuses two ranks on one card: "
                                 "share a card over gloo")
        torch.cuda.set_device(local % cards)
        torch.zeros(1, device="cuda")     # the context, before the mesh
    return init_device_mesh(device_type, (time, band), mesh_dim_names=AXES)


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def is_root(mesh: Optional[DeviceMesh]) -> bool:
    """Whether this rank owns the source (no mesh: the only rank)."""
    return mesh is None or dist.get_rank() == 0


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _peer(group, group_rank: int) -> int:
    """A group rank as the global rank ``src``/``dst``/``peer`` take."""
    return dist.get_global_rank(group, group_rank)


def ring_shift_left(x: torch.Tensor, mesh: DeviceMesh,
                    axis: str = "time") -> torch.Tensor:
    """``ppermute`` to the left neighbour on the ``axis`` ring: rank k
    sends ``x`` to k-1 and returns what k+1 sent.  A ring of one returns
    ``x`` (torch refuses a send to the sender's own rank)."""
    group = mesh.get_group(axis)
    s = dist.get_world_size(group)
    if s == 1:
        return x
    k = dist.get_rank(group)
    src = x.contiguous()
    if _via_host(x, group):
        src = src.cpu()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, _peer(group, (k - 1) % s), group),
           dist.P2POp(dist.irecv, buf, _peer(group, (k + 1) % s), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return buf.to(x.device)


def _inplace(fn, x: torch.Tensor, group, **kw) -> torch.Tensor:
    """Run the in-place collective ``fn`` on ``x`` (through a host copy
    where gloo carries a CUDA tensor) and return the result."""
    if _via_host(x, group):
        h = x.cpu()
        fn(h, group=group, **kw)
        return h.to(x.device)
    x = x.contiguous()
    fn(x, group=group, **kw)
    return x


def all_reduce_mode(x: torch.Tensor, mode: str, mesh: DeviceMesh,
                    axis: str = "time") -> torch.Tensor:
    """The cross-rank reduction of a cumulate mode: AVG/RAW partial sums
    ``all_reduce(SUM)`` (``psum``), MAX ``all_reduce(MAX)`` (``pmax``),
    MIN ``all_reduce(MIN)`` (``pmin``).  Returns a new tensor."""
    return _inplace(dist.all_reduce, x.clone(), mesh.get_group(axis),
                    op=_REDUCE_OPS[mode])


def broadcast_from_last(x: torch.Tensor, mesh: DeviceMesh,
                        axis: str = "time") -> torch.Tensor:
    """The last rank's ``x`` on every rank of ``axis``: exact, where JAX
    sums a one-hot masked value."""
    group = mesh.get_group(axis)
    last = _peer(group, dist.get_world_size(group) - 1)
    return _inplace(dist.broadcast, x.clone(), group, src=last)


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh,
                    axis: str = "band") -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (the
    tiled ``all_gather``).  A list gather: ``all_gather_into_tensor`` is
    deprecated in torch 2.13 and its successor is missing from 2.11."""
    group = mesh.get_group(axis)
    src = x.contiguous()
    if _via_host(x, group):
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh,
                axis: str = "time") -> Optional[torch.Tensor]:
    """Every rank's rows concatenated on the group's rank 0, None on the
    others (rows stay on their rank otherwise; for tests and scripts)."""
    group = mesh.get_group(axis)
    src = x.contiguous()
    if _via_host(x, group):
        src = src.cpu()
    root = dist.get_rank(group) == 0
    parts = ([torch.empty_like(src) for _ in range(dist.get_world_size(group))]
             if root else None)
    dist.gather(src, parts, dst=_peer(group, 0), group=group)
    return torch.cat(parts).to(x.device) if root else None


def agree(flag: bool, mesh: DeviceMesh) -> bool:
    """Rank 0's ``flag`` on every rank of the world: the session loops'
    stop decision, so no rank waits in a collective the others left."""
    t = torch.tensor([int(flag)], dtype=torch.int64,
                     device=rank_device(mesh))
    return bool(_inplace(dist.broadcast, t, None, src=0).item())


def _header(tensors: Optional[Sequence[torch.Tensor]], mesh: DeviceMesh):
    """Rank 0's tensors' (dtype, shape) on every rank of the world."""
    h = torch.zeros(4 * _HEADER_TENSORS, dtype=torch.int64,
                    device=rank_device(mesh))
    if dist.get_rank() == 0:
        if len(tensors) > _HEADER_TENSORS:
            raise ValueError(f"at most {_HEADER_TENSORS} tensors a call")
        for i, t in enumerate(tensors):
            if t.dim() > 2 or t.dtype not in _DTYPES:
                raise ValueError(f"cannot scatter a {t.dtype} tensor of "
                                 f"{t.dim()} dims")
            shape = list(t.shape) + [1] * (2 - t.dim())
            h[4 * i:4 * i + 4] = torch.tensor(
                [_DTYPES.index(t.dtype) + 1, t.dim(), *shape])
    h = _inplace(dist.broadcast, h, None, src=0).tolist()
    return [(_DTYPES[h[i] - 1], tuple(h[i + 2:i + 2 + h[i + 1]]))
            for i in range(0, len(h), 4) if h[i]]


def replicate(tensors: Optional[Sequence[torch.Tensor]],
              mesh: DeviceMesh) -> List[torch.Tensor]:
    """Rank 0's tensors on every rank (``in_specs=P()`` of a host array),
    on each rank's device.  Other ranks pass None."""
    dev = rank_device(mesh)
    out = []
    for i, (dtype, shape) in enumerate(_header(tensors, mesh)):
        x = (tensors[i].to(dev) if dist.get_rank() == 0
             else torch.empty(shape, dtype=dtype, device=dev))
        out.append(_inplace(dist.broadcast, x, None, src=0))
    return out


def scatter_rows(tensors: Optional[Sequence[torch.Tensor]],
                 mesh: DeviceMesh, axis: str) -> List[torch.Tensor]:
    """Rank 0's tensors split along dim 0 over ``axis`` (``in_specs=
    P(axis)`` of a host array): each rank gets its contiguous slice of
    each, on its device.  The other dim of the mesh holds replicas: rank 0
    first broadcasts to the first rank of each of them.  Other ranks pass
    None; the row count must divide by the axis size."""
    dev = rank_device(mesh)
    meta = _header(tensors, mesh)
    other = AXES[1 - AXES.index(axis)]
    group = mesh.get_group(axis)
    s, k = dist.get_world_size(group), dist.get_rank(group)
    out = []
    for i, (dtype, shape) in enumerate(meta):
        if shape[0] % s:
            raise ValueError(f"{shape[0]} rows do not split over {s} "
                             f"'{axis}' ranks")
        full = None
        if k == 0:   # the first rank of this axis group holds the whole
            full = (tensors[i].to(dev) if dist.get_rank() == 0
                    else torch.empty(shape, dtype=dtype, device=dev))
            if axis_size(mesh, other) > 1:
                full = _inplace(dist.broadcast, full, mesh.get_group(other),
                                src=0)
        local = torch.empty((shape[0] // s,) + shape[1:], dtype=dtype,
                            device=dev)
        if s == 1:
            out.append(full)
            continue
        host = _via_host(local, group)
        recv = local.cpu() if host else local
        parts = None
        if k == 0:
            parts = [p.contiguous() for p in
                     (full.cpu() if host else full).chunk(s)]
        dist.scatter(recv, parts, src=_peer(group, 0), group=group)
        out.append(recv.to(dev))
    return out
