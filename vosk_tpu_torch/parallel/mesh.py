"""Device mesh and sharding layout for the batch pipeline, over
`torch.distributed`.

Port of `vosk_tpu/parallel/mesh.py`.  The mesh is (data, model), one
process per rank:
  - `data`: channels (concurrent streams), the throughput axis.  A rank holds
    the channels of its data coordinate: feature rings, AM context, decode
    frontiers and records of B / n_data channels (`FusedPipeline.run_adaptive`
    takes the global batch's live count with a MAX all-reduce over it);
  - `model`: the acoustic model's hidden dimension (`am_param_sharding`,
    tensor parallel with explicit collectives in models/tdnnf.py), and the
    expansion of the utterance-sharded search
    (`BatchViterbi.decode_chunk_sharded`: a MIN all-reduce for the beam
    threshold and an all_gather of candidates over this axis).
Tables (the decoder's graph, replicated parameters) are each rank's own
full copy.  Where the JAX package places one global array over devices,
the port keeps each rank's slice in its own process: `shard_channel_state`
cuts a rank's channels out of a global array, `gather_channels` assembles
the global array back.

A rank runs on `cuda:{rank % device_count}` unless the caller asks for the
CPU (`device_type="cpu"`, as the tests do).  The collectives take the
group's backend: NCCL by default on CUDA, gloo where it is named (several
ranks on one card; NCCL refuses that) and on the CPU.  gloo takes CUDA
tensors for the collectives used here after a synchronise of the current
stream (`_ready`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DIMS = ("data", "model")


def default_backend(device_type: str) -> str:
    """NCCL on CUDA, gloo on the CPU: the backend a rank's process group
    takes when the caller names none."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu'; got {device_type!r}")
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str) -> torch.device:
    """The device of this process's rank: cuda:{rank % device_count}, or the
    CPU when asked for."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; none is visible "
                           "(ask for device_type='cpu' to run on the CPU)")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def make_mesh(n_data=None, n_model: int = 1, device_type: str = "cuda",
              backend=None) -> DeviceMesh:
    """The (data, model) mesh over this process group's ranks, rank r at
    coordinate (r // n_model, r % n_model).  The default process group must
    be initialised (parallel/launch.py `run_group` does it) with `backend`
    (None: `default_backend(device_type)`); n_data None takes every rank.
    On CUDA the rank's device becomes the current one."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/launch.py run_group starts one per rank)")
    want = backend or default_backend(device_type)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group runs {have!r}, not the {want!r} asked for")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) needs {n_data * n_model} ranks; "
                         f"the group has {world}")
    dev = rank_device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(device_type, torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=DIMS)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(DIMS.index(axis))


def channel_slice(mesh: DeviceMesh, batch: int) -> slice:
    """The channels of this rank's data coordinate, out of `batch`."""
    n = axis_size(mesh, "data")
    if batch % n:
        raise ValueError(f"batch {batch} is not divisible by the mesh's {n} data ranks")
    b = batch // n
    d = mesh.get_local_rank("data")
    return slice(d * b, (d + 1) * b)


def am_param_sharding(mesh: DeviceMesh, name: str, shape):
    """Tensor-sharding rule for TDNN-F parameters over the `model` axis, as
    the source decides it: a matrix on its last axis where that divides by
    the model size, else on its first; a vector on its only axis; else
    replicated.  Returns the axis the parameter is sharded on, or None
    (replicated; always so over a model axis of one rank)."""
    n_model = axis_size(mesh, "model")
    if n_model == 1:
        return None
    if len(shape) == 2:
        if shape[1] % n_model == 0:
            return 1
        if shape[0] % n_model == 0:
            return 0
    if len(shape) == 1 and shape[0] % n_model == 0:
        return 0
    return None


def local_shard(mesh: DeviceMesh, x: torch.Tensor, dim) -> torch.Tensor:
    """This rank's contiguous block of x along `dim` over the model axis (x
    itself when dim is None)."""
    if dim is None:
        return x
    n = axis_size(mesh, "model")
    return x.tensor_split(n, dim=dim)[mesh.get_local_rank("model")].contiguous()


def shard_am_params(mesh: DeviceMesh, params: dict) -> dict:
    """Each rank's shard of every parameter (numpy or tensor), by
    `am_param_sharding`; replicated ones whole."""
    out = {}
    for k, v in params.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        out[k] = local_shard(mesh, t, am_param_sharding(mesh, k, t.shape))
    return out


def shard_channel_state(mesh: DeviceMesh, state):
    """This rank's channels of a global per-channel state: a tensor, or a
    (nested) dict of them, leading dim = channels."""
    if isinstance(state, dict):
        return {k: shard_channel_state(mesh, v) for k, v in state.items()}
    return state[channel_slice(mesh, state.shape[0])].contiguous()


def _ready(x: torch.Tensor, group) -> None:
    """gloo reads and writes CUDA tensors outside the current stream: let
    the stream's work on them finish first."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        torch.cuda.current_stream(x.device).synchronize()


def all_reduce_min(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """x reduced by MIN over `axis`, in place (and returned)."""
    g = mesh.get_group(axis)
    _ready(x, g)
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=g)
    return x


def all_reduce_max(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """x reduced by MAX over `axis`, in place (and returned)."""
    g = mesh.get_group(axis)
    _ready(x, g)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


def all_gather_cat(mesh: DeviceMesh, axis: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's x over `axis`, concatenated along `dim` in group-rank
    (coordinate) order: the source's all_gather(..., tiled=True)."""
    g = mesh.get_group(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    _ready(x, g)
    dist.all_gather(parts, x, group=g)
    return torch.cat(parts, dim=dim)


def all_reduce_sum(mesh: DeviceMesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    g = mesh.get_group(axis)
    x = x.contiguous()
    _ready(x, g)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def gather_channels(mesh: DeviceMesh, x, dim: int = 0):
    """The global array over every channel that the ranks' slices x (channels
    on `dim`) stand for, in data-coordinate order: what the JAX package's
    channel-sharded arrays hold.  A tensor or a (nested) dict of them."""
    if isinstance(x, dict):
        return {k: gather_channels(mesh, v, dim) for k, v in x.items()}
    if axis_size(mesh, "data") == 1:
        return x
    return all_gather_cat(mesh, "data", x, dim)
