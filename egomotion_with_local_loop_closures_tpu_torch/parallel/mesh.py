"""Process-group and device-mesh helpers.

Port of ``egomotion_with_local_loop_closures_tpu/parallel/mesh.py``.  The
framework's parallel axes:

- ``video``: independent video streams, one per device (group), with no
  communication in steady state (on one card, the leading video axis of
  ``parallel/sharded.py::batched_process_interval``);
- ``pixel``: the rows of one keyframe template split over ranks inside a
  Gauss-Newton linearization, the 6x6 blocks summed by ``all_reduce``
  (the reference's 3-thread row striping, PixelWisePyramid.cpp:416-455).

The JAX package joins hosts with ``jax.distributed.initialize`` and
builds a ``jax.sharding.Mesh``; here the processes join one
``torch.distributed`` process group and the mesh is a ``DeviceMesh``
with the same axis names.  The JAX package's ``NamedSharding`` over the
video axis and its replicated sharding become the DTensor placements
``Shard(0)`` and ``Replicate()``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join this process to the job's ``torch.distributed`` process group.

    The reference's only multi-host mechanism is its filesystem pipeline,
    text files and a process restart (``bin/ELLC_LC.sh:4-19``); here the
    processes join one group and the collectives run through it.

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` default to the torchrun contract's ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  ``backend`` defaults to
    "nccl" where there is a CUDA card and "gloo" elsewhere; "gloo" also
    takes CUDA tensors (staged through the host), which lets two ranks
    share one card.  Call it once per process, before any collective."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{env['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_mesh(video: int = 1, pixel: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (video, pixel) mesh over the ranks of the process group, in rank
    order: the video axis outer, the pixel axis inner (keep a pixel group
    on one host, where its ``all_reduce`` is fastest)."""
    n = video * pixel
    have = dist.get_world_size()
    if n != have:
        raise ValueError(f"a {video}x{pixel} mesh needs {n} ranks, the "
                         f"group has {have}")
    return init_device_mesh(device_type, (video, pixel),
                            mesh_dim_names=("video", "pixel"))


def video_sharding(mesh: DeviceMesh):
    """Placements that shard a tensor's leading (video) axis over the
    mesh's video axis and replicate it over the pixel axis."""
    return [Shard(0), Replicate()]


def replicated(mesh: DeviceMesh):
    """Placements that replicate a tensor on every rank of the mesh."""
    return [Replicate()] * mesh.ndim
