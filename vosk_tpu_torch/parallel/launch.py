"""Start one process per rank of a (data, model) mesh and run a function in
each.

    results = run_group(fn, n_data, n_model, device_type="cuda", backend="gloo",
                        args=(...), timeout=120)

`fn(mesh, *args)` runs in every rank, in a process started with
`torch.multiprocessing`'s spawn (so `fn` and `args` must pickle: a
module-level function, and plain data); it returns what that rank
computed, which comes back pickled, in rank order.  The ranks meet at a
`FileStore` in a temporary directory (no TCP port to collide with another
group).  A rank that raises makes `run_group` raise with its traceback, and
a group that does not finish within `timeout` seconds is terminated and
raises: a collective left waiting on a dead rank fails instead of hanging.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import default_backend, make_mesh


class RankError(RuntimeError):
    """A rank of a group raised; the message holds its traceback."""


def _rank_main(rank, world, store_dir, n_data, n_model, device_type, backend, timeout,
               results):
    try:
        with open(os.path.join(store_dir, "call"), "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout))
        try:
            mesh = make_mesh(n_data, n_model, device_type, backend)
            out = fn(mesh, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_group(fn, n_data: int, n_model: int = 1, device_type: str = "cuda", backend=None,
              args: tuple = (), timeout: float = 300.0) -> list:
    """Run fn(mesh, *args) on every rank of an (n_data, n_model) mesh, one
    spawned process each, and return their results in rank order.  backend
    None: NCCL on CUDA, gloo on the CPU (`mesh.default_backend`).  Raises
    RankError with the first failing rank's traceback, or TimeoutError."""
    backend = backend or default_backend(device_type)
    world = n_data * n_model
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="vt_group_")
    # the call goes through a file: a start() whose pickled arguments pass
    # the pipe's buffer would wait for the child to read them
    with open(os.path.join(store_dir, "call"), "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, store_dir, n_data, n_model, device_type, backend, timeout, results))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        out: dict = {}
        deadline = time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the group of {world} ranks did not finish within "
                                   f"{timeout} s; ranks done: {sorted(out)}")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    # a rank died without a word (killed, out of memory)
                    raise RankError(f"rank {dead[0]} exited with code "
                                    f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RankError(f"rank {rank} of {world} raised:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
