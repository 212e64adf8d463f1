"""Multi-process execution on ``torch.distributed`` (twin of ``ml_depth_pro_video_tpu/parallel/multihost.py``).

The JAX package runs one controller per host that drives every local chip,
joined across hosts by ``jax.distributed``. The port runs one process per
rank with each rank on one device, the idiom of ``torch.distributed`` and
``torchrun``: a host with N cards is N ranks, and what the JAX package
calls a pod (``jax.process_count() > 1``) is a group of more than one rank.

- :func:`initialize` joins the group from flags or torchrun's environment
  (idempotent; a single process creates no group) and puts each rank on
  ``cuda:(local_rank % device_count)``.
- The backend of tensor collectives is chosen once, by rule
  (:func:`choose_backend`): ``nccl`` where every rank of a host has a card
  of its own, ``gloo`` where ranks share a card (NCCL refuses two ranks on
  one device) or compute on the CPU. Host objects (file lists, the ground
  plane, stop flags) always travel over the gloo group.
- The collectives of tensors, each over the whole group or a process group
  of a mesh axis (``parallel/mesh.py::with_groups``), on the tensors'
  device, the compute staying on the card: :func:`all_gather`,
  :func:`all_reduce` (a sum) and :func:`broadcast`; the point-to-point
  steps :func:`transfer` (sends to some ranks, receives from others) and
  :func:`exchange` (a rank and its neighbours). gloo's all_gather takes CUDA
  tensors itself and stages them through host memory; for the others gloo
  is given pinned host copies of CUDA tensors (its send and recv take host
  memory only), and its sums of bf16 or fp16 run in fp32.
- :func:`rows_for_process` / :func:`local_rows` / :func:`local_item_count`
  / :func:`local_output`: the rows of a dp-split batch that a rank holds.
- :func:`is_primary`, :func:`barrier`, :func:`any_flag`,
  :func:`broadcast_from_primary`, :func:`broadcast_text`,
  :func:`broadcast_json`: host-side agreement across ranks.

The JAX package's ``global_batch`` has no counterpart: JAX assembles one
global array from every host's rows for one SPMD program, while here each
rank keeps its own rows and runs the per-frame program on them
(``parallel/spmd.py``). Single-process, every helper is the identity.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """The joined group: this rank's place in it and the chosen backend."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    hosts: int
    backend: str
    reason: str
    compute_group: object  # tensor collectives (nccl or gloo)
    host_group: object     # host objects (gloo)


_CLUSTER: Cluster | None = None


def choose_backend(device_type: str, ranks_per_host: list, devices_per_host: list) -> tuple:
    """(backend, reason) of the tensor collectives: nccl when the ranks compute
    on CUDA and no host has more ranks than cards, else gloo."""
    if device_type != "cuda":
        return "gloo", "the ranks compute on the CPU"
    short = [(r, d) for r, d in zip(ranks_per_host, devices_per_host) if r > d]
    if short:
        r, d = short[0]
        return "gloo", (f"{r} ranks share {d} CUDA device(s) on one host: NCCL needs a device "
                        "per rank, gloo stages through pinned host memory")
    return "nccl", "every rank has a CUDA device of its own"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> bool:
    """Join (or form) the process group; call it on every rank before the model
    is built. The arguments come from the flags or torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``).
    ``device`` is the ranks' compute device type (``cuda`` when CUDA is
    available, else ``cpu``). Returns True when more than one rank joined,
    False for a single process (then no group is created). Idempotent."""
    global _CLUSTER
    if _CLUSTER is not None:
        return _CLUSTER.world > 1
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if not dist.is_initialized():
        if num_processes is None or num_processes <= 1:
            return False
        if coordinator_address is None or process_id is None:
            raise ValueError("a group of several processes needs --coordinator host:port and "
                             "--process_id (or torchrun's MASTER_ADDR/MASTER_PORT and RANK)")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world == 1:
        return False
    dev_type = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ranks asked for CUDA but CUDA is not available")
    n_dev = torch.cuda.device_count() if dev_type == "cuda" else 0
    info = [None] * world
    dist.all_gather_object(info, (socket.gethostname(), n_dev))
    hosts: dict = {}
    for r, (host, _) in enumerate(info):
        hosts.setdefault(host, []).append(r)
    mine = hosts[info[rank][0]]
    local_rank = int(env["LOCAL_RANK"]) if env.get("LOCAL_RANK") else mine.index(rank)
    backend, reason = choose_backend(dev_type, [len(rs) for rs in hosts.values()],
                                     [info[rs[0]][1] for rs in hosts.values()])
    if dev_type == "cuda":
        torch.cuda.set_device(local_rank % n_dev)
    compute = dist.new_group(backend="nccl") if backend == "nccl" else dist.group.WORLD
    _CLUSTER = Cluster(rank, world, local_rank, len(mine), len(hosts), backend, reason,
                       compute, dist.group.WORLD)
    LOGGER.info("multihost: rank %d/%d (local %d/%d on %d host(s)), tensor collectives on %s: %s",
                rank, world, local_rank, len(mine), len(hosts), backend, reason)
    return True


def cluster() -> Cluster | None:
    """The joined group, or None single-process."""
    return _CLUSTER


def add_multihost_args(parser) -> None:
    """Attach the multi-host flags (the JAX package's names) to a parser."""
    g = parser.add_argument_group("multi-host")
    g.add_argument("--coordinator", default=None,
                   help="rank 0's address host:port (or torchrun's MASTER_ADDR/MASTER_PORT)")
    g.add_argument("--num_processes", type=int, default=None,
                   help="total number of ranks (one per device)")
    g.add_argument("--process_id", type=int, default=None,
                   help="this rank in [0, num_processes)")


def initialize_from_args(args) -> bool:
    return initialize(getattr(args, "coordinator", None), getattr(args, "num_processes", None),
                      getattr(args, "process_id", None), getattr(args, "device", None))


def rank() -> int:
    return 0 if _CLUSTER is None else _CLUSTER.rank


def world_size() -> int:
    return 1 if _CLUSTER is None else _CLUSTER.world


def host_count() -> int:
    return 1 if _CLUSTER is None else _CLUSTER.hosts


def local_world_size() -> int:
    return 1 if _CLUSTER is None else _CLUSTER.local_world


def is_primary() -> bool:
    return rank() == 0


def make_pod_mesh(dp: int | None = None, tp: int = 1):
    """A (dp, tp) mesh over every rank, rejecting a ``tp`` whose groups would
    straddle hosts unevenly (ranks are numbered host by host)."""
    from .mesh import make_mesh

    local = local_world_size()
    if tp > 1 and local % tp != 0 and tp % local != 0:
        raise ValueError(f"tp={tp} does not tile the {local} local devices per host; "
                         "tensor-parallel groups would straddle hosts unevenly")
    return make_mesh(dp=dp, tp=tp)


def rows_for_process(sharding, global_shape, process_index: int) -> list[int]:
    """Leading-dim rows of a ``global_shape`` batch held by ``process_index``."""
    return sharding.rows(process_index, int(global_shape[0]))


def local_rows(sharding, global_shape) -> list[int]:
    """The rows THIS rank supplies / holds (all of them single-process)."""
    return rows_for_process(sharding, global_shape, rank())


def local_item_count(sharding, batch_size: int, n_items: int) -> int:
    """How many of ``n_items`` stream elements THIS rank yields when the stream
    is consumed in batches of ``batch_size`` rows split by ``sharding`` (the
    yield rule of ``DepthVideoRunner.depth_stream_multihost``: tail rows past
    ``n_items`` are padding and never yielded)."""
    rows = local_rows(sharding, (batch_size,))
    n_batches = (n_items + batch_size - 1) // batch_size
    return sum(1 for g in range(n_batches) for r in rows if g * batch_size + r < n_items)


def local_output(local: torch.Tensor, sharding, global_rows: int) -> tuple[np.ndarray, list[int]]:
    """This rank's rows of a result as (host values, their global row numbers);
    nothing is gathered from other ranks."""
    return local.cpu().numpy(), local_rows(sharding, (global_rows,))


def _group(group):
    return _CLUSTER.compute_group if group is None else group


def all_gather(t: torch.Tensor, shapes=None, group=None) -> list[torch.Tensor]:
    """Every member's ``t``, in rank order, on ``t``'s device; ``group`` is a
    process group of a mesh axis (the whole group by default). ``shapes``
    gives every member's shape where they differ (each is padded to the
    largest and trimmed back); by default they all have ``t``'s."""
    if _CLUSTER is None:
        return [t]
    g = _group(group)
    size = dist.get_world_size(g)
    shapes = [tuple(t.shape)] * size if shapes is None else [tuple(s) for s in shapes]
    full = tuple(max(s[d] for s in shapes) for d in range(t.dim()))
    send = t.contiguous()
    if tuple(send.shape) != full:
        pad = send.new_zeros(full)
        pad[tuple(slice(0, n) for n in send.shape)] = send
        send = pad
    # bytes on the wire: gloo's all_gather does not take every dtype (bf16)
    out = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather([o.view(torch.uint8) for o in out], send.view(torch.uint8), group=g)
    return [o[tuple(slice(0, n) for n in s)] for o, s in zip(out, shapes)]


def _staged(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """What gloo is given for ``t``: a host copy (pinned for a CUDA tensor),
    in ``dtype`` (default ``t``'s)."""
    dtype = t.dtype if dtype is None else dtype
    if t.device.type == "cpu":
        return t.to(dtype, copy=True)
    host = torch.empty(t.shape, dtype=dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every member's ``t`` (a new tensor, on ``t``'s device, equal
    on every member); ``group`` as for :func:`all_gather`. gloo sums bf16 and
    fp16 in fp32 and rounds the sum back once."""
    if _CLUSTER is None:
        return t
    g = _group(group)
    if _CLUSTER.backend == "nccl":
        out = t.clone()
        dist.all_reduce(out, group=g)
        return out
    low = t.dtype in (torch.bfloat16, torch.float16)
    work = _staged(t, torch.float32 if low else None)
    dist.all_reduce(work, group=g)
    return work.to(t.device, t.dtype, non_blocking=t.device.type != "cpu")


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a global rank, a member of ``group``) on every
    member, a new tensor on ``t``'s device; the others' ``t`` gives only the
    shape and dtype."""
    if _CLUSTER is None:
        return t
    g = _group(group)
    if _CLUSTER.backend == "nccl":
        out = t.contiguous().clone()
        dist.broadcast(out.view(torch.uint8), src, group=g)
        return out
    work = _staged(t)
    dist.broadcast(work.view(torch.uint8), src, group=g)
    return work.to(t.device, non_blocking=t.device.type != "cpu")


def transfer(sends: dict, recvs: dict) -> dict:
    """Point to point: ``sends[peer]`` goes to each peer rank, and from each
    peer of ``recvs`` comes a tensor like ``recvs[peer]`` (a tensor of the
    shape, dtype and device to receive; its values are not read), all in one
    batch of isend/irecv on the tensor group; a peer calls this with this
    rank among its ``recvs`` and ``sends`` the other way round. Returns
    {peer: received}."""
    if _CLUSTER is None or not (sends or recvs):
        return {}
    c = _CLUSTER
    ops, got = [], {}
    keep = []  # the staged sends live until the batch completes
    for peer, t in sends.items():
        send = _staged(t) if c.backend == "gloo" and t.device.type != "cpu" else t.contiguous()
        keep.append(send)
        # bytes on the wire, as all_gather sends them
        ops.append(dist.P2POp(dist.isend, send.view(torch.uint8), peer, c.compute_group))
    for peer, like in recvs.items():
        stage = c.backend == "gloo" and like.device.type != "cpu"
        recv = torch.empty(like.shape, dtype=like.dtype, device="cpu" if stage else like.device,
                           pin_memory=stage)
        ops.append(dist.P2POp(dist.irecv, recv.view(torch.uint8), peer, c.compute_group))
        got[peer] = (recv, like.device)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return {peer: recv.to(device) for peer, (recv, device) in got.items()}


def exchange(sends: dict) -> dict:
    """Point to point: ``sends[peer]`` goes to each peer rank, and from each
    comes a tensor of the same shape and dtype (the peer calls this with this
    rank among its peers). Returns {peer: received} on the sent tensors'
    devices."""
    return transfer(sends, sends)


def barrier(name: str = "barrier") -> None:
    """Block until every rank reaches this point."""
    if _CLUSTER is not None:
        dist.barrier(group=_CLUSTER.host_group)


def any_flag(flag: bool) -> bool:
    """Group-wide OR of a rank-local boolean (e.g. "did THIS rank catch
    SIGINT?"). Every rank calls it at the same program point, so every rank
    takes the same branch after it."""
    if _CLUSTER is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_CLUSTER.host_group)
    return bool(t.item())


def broadcast_from_primary(obj):
    """Rank 0's host object on every rank (pickled over the gloo group, so
    values keep their types and precision)."""
    if _CLUSTER is None:
        return obj
    box = [obj if is_primary() else None]
    dist.broadcast_object_list(box, src=0, group=_CLUSTER.host_group)
    return box[0]


def broadcast_text(text: str | None) -> str:
    """Rank 0's string, exactly, on every rank; other ranks may pass None."""
    if _CLUSTER is None:
        return text if text is not None else ""
    return broadcast_from_primary((text or "") if is_primary() else None)


class _NumpyEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
        return super().default(o)


def broadcast_json(obj):
    """Rank 0's JSON-serialisable value on every rank, floats exact (repr round
    trip); other ranks may pass None."""
    text = json.dumps(obj, cls=_NumpyEncoder) if is_primary() else None
    return json.loads(broadcast_text(text))
