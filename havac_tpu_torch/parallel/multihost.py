"""Processes, shards and host-local staging for the mesh sweeps.

The counterpart of `havac_tpu/parallel/multihost.py`:

  1. every process calls :func:`initialize` (``torch.distributed`` over a
     TCP rendezvous, with the backend the caller names: ``nccl`` for CUDA
     tensors, ``gloo`` for host memory);
  2. :func:`global_sequence_mesh` builds one 1-D :class:`ShardMesh` over
     every process's shards, and :func:`sequence_model_mesh` a 2-D
     (sequence x model) one: the flat grid of shards laid out seq-major, as
     JAX reshapes ``jax.devices()`` to ``(-1, model_parallel)``, each
     process holding a contiguous run of it (flat shard f = rank *
     shards_per_process + i, at seq shard f // D_model of model group
     f % D_model);
  3. each process stages only its own shards' symbols
     (:func:`host_local_codes`, :func:`local_row_range`);
  4. each process resolves only its own shards' hits; coordinates are
     global, so the processes' hit lists together are the whole result.

In one process (``group`` None) every shard is local and nothing is
exchanged between processes. The JAX package's replicated record-cap
collectives have no counterpart here: the sweep kernel counts its keys
exactly and regrows a buffer locally.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist


class ShardMesh:
    """A mesh of sequence shards, optionally cut along a model axis too: the
    port's stand-in for a ``jax.sharding.Mesh``.

    ``devices`` lists this process's shards in order; a device may repeat
    (several shards on one card, or on the CPU). ``group`` is the
    ``torch.distributed`` process group the shards span, or None for one
    process. Every process holds ``len(devices)`` shards: flat shard f lives
    on process f // len(devices). Without ``model_axis`` the mesh is 1-D,
    ``shape`` ``{axis: D}`` and ``axis_names`` ``(axis,)``. With it, the
    flat shards form a seq-major (D_seq, D_model) grid, D_model =
    ``model_parallel``: ``shape`` is ``{axis: D_seq, model_axis: D_model}``
    and ``axis_names`` ``(axis, model_axis)``, so ``mesh.shape[axis]``
    reads as with JAX. A 1-D mesh is the grid with D_model = 1.
    """

    def __init__(self, devices: Sequence[Union[str, torch.device]],
                 group=None, axis: str = "seq",
                 model_axis: Optional[str] = None,
                 model_parallel: int = 1) -> None:
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.axis = axis
        self.model_axis = model_axis
        self.world_size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        n = self.world_size * len(self.devices)
        self.model_parallel = int(model_parallel)
        if model_axis is None and self.model_parallel != 1:
            raise ValueError("model_parallel needs a model_axis")
        if self.model_parallel < 1 or n % self.model_parallel:
            raise ValueError(f"{n} shards not divisible by model_parallel="
                             f"{self.model_parallel}")
        self.shape = {axis: n // self.model_parallel}
        if model_axis is not None:
            self.shape[model_axis] = self.model_parallel
        self.axis_names = tuple(self.shape)

    @property
    def backend(self) -> Optional[str]:
        """The group's backend (``"gloo"``, ``"nccl"``), None in one
        process."""
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def shards_per_process(self) -> int:
        return len(self.devices)

    def global_rank(self, rank: int) -> int:
        """The global rank of the group's ``rank``: what point-to-point
        calls name."""
        return dist.get_global_rank(self.group, rank)

    # The seq-major grid: flat shard f = k * D_model + m is seq shard k of
    # model group m.

    def coords(self, flat: int) -> Tuple[int, int]:
        """(seq shard, model group) of flat shard ``flat``."""
        return divmod(int(flat), self.model_parallel)

    def flat(self, k: int, m: int = 0) -> int:
        """The flat index of seq shard ``k`` of model group ``m``."""
        return int(k) * self.model_parallel + int(m)

    def owner(self, k: int, m: int = 0) -> int:
        """The rank (in ``group``) of the process holding shard (k, m)."""
        return self.flat(k, m) // self.shards_per_process

    def local_shards(self, m: int = 0) -> range:
        """The seq shards of model group ``m`` this process holds: a
        contiguous run, empty when it holds none of the group."""
        lo = self.rank * self.shards_per_process
        hi = lo + self.shards_per_process
        return range(-(-(lo - m) // self.model_parallel),
                     -(-(hi - m) // self.model_parallel))

    def seq_shards(self) -> range:
        """The seq shards any of this process's shards cover."""
        lo = self.rank * self.shards_per_process
        hi = lo + self.shards_per_process
        return range(lo // self.model_parallel,
                     (hi - 1) // self.model_parallel + 1)

    def device(self, k: int, m: int = 0) -> torch.device:
        """The device of this process's shard (k, m)."""
        return self.devices[self.flat(k, m)
                            - self.rank * self.shards_per_process]

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={d}" for a, d in self.shape.items())
        return (f"ShardMesh({axes}, rank {self.rank}/{self.world_size}, "
                f"devices {[str(d) for d in self.devices]}, backend "
                f"{self.backend})")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = "nccl") -> None:
    """Join ``torch.distributed``'s default group (no-op when it is already
    initialised): ``coordinator_address`` is ``host:port`` of the TCP
    rendezvous (or a ``tcp://`` URL), as JAX's ``initialize`` takes it.
    ``backend`` is the caller's choice; nothing switches it."""
    if dist.is_initialized():
        return
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


def global_sequence_mesh(axis: str = "seq",
                         devices: Optional[Sequence] = None,
                         group=None) -> ShardMesh:
    """One 1-D mesh over every process's shards. ``devices`` are this
    process's shards (default: its current CUDA device, one shard);
    ``group`` defaults to the default group when ``torch.distributed`` is
    initialised. Every process must hold the same number of shards (checked
    across the group; a collective, so every process calls this)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name this process's shards "
                               "with devices=")
        devices = [torch.device("cuda", torch.cuda.current_device())]
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    mesh = ShardMesh(devices, group=group, axis=axis)
    if group is not None:
        counts = all_gather_int(mesh, len(mesh.devices))
        if len(set(counts)) != 1:
            raise ValueError(f"processes hold unequal shard counts {counts}")
    return mesh


def sequence_model_mesh(model_parallel: int, seq_axis: str = "seq",
                        model_axis: str = "model",
                        devices: Optional[Sequence] = None,
                        group=None) -> ShardMesh:
    """The 2-D (sequence x model) mesh over every process's shards, as
    :func:`global_sequence_mesh` takes them, laid out seq-major with
    ``model_parallel`` model groups (JAX's ``reshape(-1, model_parallel)``).
    The model axis cuts the collection at model boundaries only
    (:mod:`~havac_tpu_torch.parallel.swar_dist2d`). Raises ValueError when
    the shards do not divide into ``model_parallel`` groups."""
    flat = global_sequence_mesh(seq_axis, devices, group)
    return ShardMesh(flat.devices, flat.group, seq_axis, model_axis,
                     model_parallel)


def shard_width(length: int, mesh: ShardMesh, axis: str = "seq") -> int:
    """Positions a shard covers: the database is cut into D equal shards,
    the last ones padded past its end."""
    return max(1, -(-int(length) // mesh.shape[axis]))


def local_row_range(total_rows: int, mesh: ShardMesh, axis: str = "seq"
                    ) -> Tuple[int, int]:
    """[lo, hi) of the leading-axis rows this process's shards cover when
    ``total_rows`` rows are cut into the mesh's D_seq equal seq shards."""
    D = mesh.shape[axis]
    if axis != mesh.axis:
        raise ValueError(f"rows are cut along the seq axis {mesh.axis!r}, "
                         f"not {axis!r}")
    if total_rows % D:
        raise ValueError(f"{total_rows} rows do not cut into {D} shards")
    per = total_rows // D
    ks = mesh.seq_shards()
    return ks.start * per, ks.stop * per


def host_local_codes(codes: np.ndarray, mesh: ShardMesh, axis: str = "seq"
                     ) -> Tuple[np.ndarray, int]:
    """This process's contiguous slice of the database and its global
    offset (the positions of the seq shards its shards cover; the slice
    ends early where the database does)."""
    L = codes.shape[0]
    W = shard_width(L, mesh, axis)
    lo, hi = local_row_range(W * mesh.shape[axis], mesh, axis)
    return codes[min(lo, L):min(hi, L)], lo


def collective_device(mesh: ShardMesh) -> torch.device:
    """Where the group's small collectives keep their tensors: host memory
    under gloo, this process's first card under NCCL."""
    return (mesh.devices[0] if mesh.backend == "nccl"
            else torch.device("cpu"))


def all_reduce_max(mesh: ShardMesh, value: int) -> int:
    """The largest ``value`` over the group's processes (``value`` itself
    in one process)."""
    if mesh.group is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=collective_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def all_gather_int(mesh: ShardMesh, value: int) -> list:
    """Every process's ``value``, in rank order."""
    if mesh.group is None:
        return [int(value)]
    dev = collective_device(mesh)
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    out = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(out, t, group=mesh.group)
    return [int(x.item()) for x in out]
