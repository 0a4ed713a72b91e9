"""Process groups, (hosts, chips) meshes, host-local loading and the
multi-host grid solve, PyTorch port of ``deeparc_tpu.parallel.multihost``.

The JAX package runs one controller over a mesh of devices; PyTorch runs
one process per device (``torchrun``, or ``torch.multiprocessing.spawn``).
So here:

  * :func:`initialize_distributed` joins the process group from explicit
    arguments or ``torchrun``'s environment and binds ``cuda:LOCAL_RANK``;
    :func:`start_group` is what the sharded entry points call: without a
    configured group it starts a one-rank group (NCCL on a card, gloo on
    the CPU), so a plain ``python`` process runs the sharded code path;
  * :class:`Reducer` is the sharded step's ``axis``: the sums that cross
    devices (``psum`` / ``pmax`` in JAX) are ``all_reduce`` calls over its
    group, and the ranks' control decisions (the wall clock, a checkpoint's
    existence) are rank 0's, broadcast;
  * a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
    (hosts, devices per host) named ("host", "chip"); point rows shard
    row-major over both axes, so the camera system reduces over the whole
    mesh.

Nothing here falls back to an unsharded solve: a failed init or
collective raises.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

HOST_AXIS = "host"
CHIP_AXIS = "chip"

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> bool:
    """Join the process group if a multi-process setup is configured.

    Explicit arguments win (``coordinator_address`` is ``host:port``);
    otherwise ``torchrun``'s ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``. ``backend`` defaults to NCCL
    when a card is present, else gloo. With NCCL the process is bound to
    ``cuda:LOCAL_RANK`` first. Returns True when the group is active."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and all(k in env for k in _TORCHRUN_ENV):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id or 0)
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_group(device, backend: str | None = None) -> None:
    """Make sure a process group is active, for a sharded entry point on
    ``device``: the configured one (:func:`initialize_distributed`), else a
    one-rank group on a free local port, NCCL for a CUDA device unless
    ``backend`` names gloo, gloo for the CPU."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if initialize_distributed(backend=backend):
        return
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)


def world_hint(n_devices: int) -> str:
    """How to start a group of ``n_devices`` ranks on one host."""
    return (f"start {n_devices} ranks, e.g. `torchrun --nproc-per-node "
            f"{n_devices} -m deeparc_tpu_torch.pipeline.cli ... --devices "
            f"{n_devices}`")


class Reducer:
    """The cross-device reductions of a sharded step over one process
    group: every per-point quantity stays on its rank, and only the camera
    side is summed. A step given ``reducer=None`` is the single-device
    step. Each call moves a fresh copy, never its argument, and counts its
    bytes in ``bytes`` (what one rank hands the collectives)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call start_group first")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self._src = dist.get_global_rank(group, 0) if group is not None else 0
        # NCCL moves CUDA tensors only; gloo gathers CPU tensors only
        self.control_device = (torch.device("cuda", torch.cuda.current_device())
                               if self.backend == "nccl"
                               else torch.device("cpu"))
        self.bytes = 0
        self.calls = 0

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        self.bytes += out.numel() * out.element_size()
        self.calls += 1
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def sum_sym(self, m: torch.Tensor) -> torch.Tensor:
        """Sum of symmetric (..., n, n) matrices, moving the lower triangle
        only ((n + 1) / (2 n) of the bytes) and mirroring it. The lower
        triangle is the one ``linalg.masked_spd_solve``'s Cholesky reads,
        so on one rank the solve gets the unsharded step's bits."""
        n = m.shape[-1]
        i, j = torch.tril_indices(n, n, device=m.device)
        packed = self.sum(m[..., i, j])
        out = torch.empty_like(m)
        out[..., i, j] = packed
        out[..., j, i] = packed
        return out

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank: a decision the ranks must take
        together (the wall-clock cap, a checkpoint's existence)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                         device=self.control_device)
        dist.broadcast(t, self._src, group=self.group)
        return bool(t.item())

    def from_rank0(self, obj):
        """Rank 0's picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, self._src, group=self.group)
        return box[0]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (the same count on each), in rank
        order, on ``x``'s device. gloo gathers CPU tensors only, so under
        gloo the rows go through the host."""
        dev = x.device
        src = x.contiguous() if self.backend == "nccl" else x.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        self.bytes += src.numel() * src.element_size()
        self.calls += 1
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(dev)

    def check_same(self, values, what: str) -> None:
        """Raise unless every rank holds the same ``values`` (shapes and
        checksums of a layout each rank built on its own): a silent
        divergence would hang the next collective or give wrong sums."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.control_device)
        hi = t.clone()
        lo = -t
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.group)
        dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=self.group)
        if not torch.equal(hi, -lo):
            raise RuntimeError(f"the ranks built different {what}: "
                               f"max {hi.tolist()} min {(-lo).tolist()}")


def load_checkpoint_shared(reducer: Reducer, path: str | None, resume: bool,
                           template):
    """(BAParams on the template's device, scalars) of the checkpoint at
    ``path`` on every rank, when ``resume`` is set and the file exists as
    rank 0 sees it (rank 0 reads it and broadcasts it); else None."""
    if not (resume and path and reducer.agree(
            reducer.rank == 0 and os.path.exists(path))):
        return None
    ck = None
    if reducer.rank == 0:
        from deeparc_tpu_torch.utils.checkpoint import load_solver_state

        ck = load_solver_state(path, dtype=template.points.dtype,
                               device="cpu")
    params, scalars = reducer.from_rank0(ck)
    return (type(params)(**{k: v.to(template.points.device)
                            for k, v in vars(params).items()}), scalars)


def reducer_for(device, mesh=None, axis=None) -> Reducer:
    """The reducer of a sharded solve on ``device``: over the whole world
    (started by :func:`start_group` if need be) when ``mesh`` is None;
    else over ``mesh``'s ``axis`` (one dimension name, or None or every
    name for the whole mesh, which must then span the world)."""
    if mesh is None:
        start_group(device)
        return Reducer()
    names = tuple(mesh.mesh_dim_names or ())
    axes = names if axis is None else (
        (axis,) if isinstance(axis, str) else tuple(axis))
    if set(axes) == set(names) and len(names) > 1:
        if mesh.size() != dist.get_world_size():
            raise ValueError("a reduction over the whole mesh needs a mesh "
                             "that spans the world")
        return Reducer()
    if len(axes) != 1:
        raise ValueError(f"axis {axis!r} of a mesh named {names}")
    return Reducer(mesh.get_group(axes[0]))


def mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_host_mesh(devices_per_host: int | None = None):
    """(hosts, chips-per-host) ``DeviceMesh`` over the world, named
    ("host", "chip"). ``devices_per_host`` defaults to ``torchrun``'s
    ``LOCAL_WORLD_SIZE`` (all ranks on one host without it). One host: a
    (1, n) mesh, the same code path everywhere."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    per = devices_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per:
        raise ValueError(f"uneven devices per host: {world} ranks, {per} a "
                         "host")
    return init_device_mesh(mesh_device_type(), (world // per, per),
                            mesh_dim_names=(HOST_AXIS, CHIP_AXIS))


def data_axes() -> tuple:
    """The axis pair point-major arrays shard over (sums over both)."""
    return (HOST_AXIS, CHIP_AXIS)


def pad_rows_to_mesh(n_rows: int, mesh) -> int:
    n_dev = int(mesh.size())
    return -(-n_rows // n_dev) * n_dev


def host_point_slice(n_rows_padded: int, mesh) -> slice:
    """The global point-row range THIS process must load.

    Point rows shard row-major over (hosts, chips): a host owns the
    contiguous block of its mesh row, and with one process per device the
    process owns its chip's block of that."""
    n_hosts, n_chips = mesh.mesh.shape
    assert n_rows_padded % (n_hosts * n_chips) == 0
    h, c = mesh.get_coordinate()
    per_host = n_rows_padded // n_hosts
    per_chip = per_host // n_chips
    lo = h * per_host + c * per_chip
    return slice(lo, lo + per_chip)


def global_from_host_local(local: np.ndarray, mesh,
                           n_global: int) -> torch.Tensor:
    """This process's rows on its device. A process-per-device program has
    no global array: each rank holds its rows, and the collectives of the
    sharded step stand for the global view; the global row count is
    checked against the mesh."""
    if local.shape[0] * int(mesh.size()) != n_global:
        raise ValueError(f"{local.shape[0]} rows on each of {mesh.size()} "
                         f"devices do not make {n_global}")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return torch.as_tensor(local, device=dev)


def gather_global(arr: torch.Tensor, group=None) -> np.ndarray:
    """Host-side copy of the rows every rank holds (the same count on
    each), in rank order: an ``all_gather`` over the group, the pattern
    checkpointing needs when no process holds the whole array. Without a
    group: a plain copy."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return arr.detach().cpu().numpy()
    return Reducer(group).gather_rows(arr.detach()).cpu().numpy()


def solve_ba_grid_multihost(params, grid, free, options=None, mesh=None,
                            chunk_size: int = 8192,
                            checkpoint_path: str | None = None,
                            checkpoint_every: int = 10, resume: bool = False,
                            logger=None, driver: str = "python",
                            while_block: int = 10, impl: str = "auto"):
    """Grid-engine LM solve sharded over a (hosts, chips) mesh.

    The math of :func:`sharded_grid.solve_ba_grid_sharded`, to which this
    delegates, with the camera system's sums over the ("host", "chip")
    PAIR, i.e. over every rank. Its guarantees carry over: the wall-clock
    cap ``options.max_seconds`` (``src/sfm.cc:71``), checkpoints written by
    rank 0, one log line per iteration (``driver="python"``) or per block
    of ``while_block`` iterations (``driver="while_loop"``, as the
    reference runs it). ``impl`` is that solve's."""
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.parallel.sharded_grid import solve_ba_grid_sharded

    options = options or SolverOptions()
    if mesh is None:
        start_group(params.points.device)
        mesh = make_host_mesh()
    return solve_ba_grid_sharded(
        params, grid, free, options, mesh=mesh, axis=data_axes(),
        chunk_size=chunk_size, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume, logger=logger,
        driver=driver, while_block=while_block, impl=impl)
