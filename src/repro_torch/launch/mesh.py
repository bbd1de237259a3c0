"""Device meshes of the port: named axes over ``torch.distributed`` ranks.

A ``Mesh`` is the small value the sharding rules and the tensor-parallel
model functions read: its axis names, its shape, and, for a mesh over an
initialised process group, this process's rank, the process group of its
"model" axis (the ranks of its data row, which hold the other shards of
its model), the process group of its "data" axis (the ranks of its model
column within its pod, which hold the same model shard and the other
ZeRO slices of it), the process group of its batch axes (its model
column across every pod and data row: the ranks whose batch rows the
gradient is averaged over) and the world.  A shape-only mesh (no group)
feeds the sharding rules and nothing else.

Ranks lie on the mesh row-major, as ``jax.make_mesh`` lays devices out:
rank ``r`` sits at batch row ``r // model`` (pod ``r // (data * model)``,
data row ``(r // model) % data``) and model column ``r % model``.

* ``make_production_mesh(multi_pod=)``: the JAX package's TPU v5e shapes,
  (16, 16) over ("data", "model") or (2, 16, 16) over ("pod", "data",
  "model"); shape only (``make_mesh`` of the same sizes over a world of
  256 or 512 ranks, ``torchrun``'s: ``init_from_env``).
* ``make_mesh(sizes)``: a ("data", "model") or ("pod", "data", "model")
  mesh of those sizes over the initialised world.
* ``make_host_mesh(model)``: the ("data", "model") mesh over the
  initialised world (data = world // model); a single process without a
  process group is a world of one.
* ``spawn_ranks(fn, n, args)``: a world of ``n`` spawned processes, each
  with its process group initialised, running ``fn(rank, *args)``;
  returns their results in rank order and raises if any rank failed or
  ran out of time (a rank that waits on a collective the others never
  reach fails at the group's timeout instead of hanging).
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch.distributed as dist
import torch.multiprocessing as mp


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named mesh axes; ``group`` is this rank's "model"-axis process
    group, ``data_group`` its "data"-axis group, ``batch_group`` the group
    of its batch axes (``data_axes``; the data group itself without a
    "pod" axis) and ``world`` the whole world's (each None on a
    shape-only mesh, and an axis's group None where the axis has size 1),
    ``rank`` its global rank."""

    axis_names: tuple
    axis_sizes: tuple
    group: Optional[Any] = None
    rank: int = 0
    data_group: Optional[Any] = None
    world: Optional[Any] = None
    batch_group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def model_index(self) -> int:
        """This rank's place on the "model" axis: which shard it holds."""
        return self.rank % self.shape.get("model", 1)

    @property
    def data_index(self) -> int:
        """This rank's batch row: its place on the batch axes (``pod *
        data + data row``), which batch rows it takes."""
        return self.rank // self.shape.get("model", 1)

    @property
    def batch_size(self) -> int:
        """The number of batch rows: the product of the batch axes."""
        return self.size // self.shape.get("model", 1)

    def axis_group(self, axis: str):
        """The process group of ``axis`` ("model" or "data")."""
        return self.group if axis == "model" else self.data_group


#: the JAX package's production meshes (TPU v5e pods): shape, axis names
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh, shape only (``make_mesh`` of
    ``PRODUCTION``'s sizes builds it over a world of 256 or 512 ranks)."""
    sizes, names = PRODUCTION[multi_pod]
    return Mesh(names, sizes)


def init_from_env(backend: Optional[str] = None) -> None:
    """Initialise the default process group from ``torchrun``'s
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) unless it is initialised already or there is no such
    environment: NCCL when every local rank has a card of its own, else
    gloo."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if backend is None:
        import torch

        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= local else "gloo")
    dist.init_process_group(backend, init_method="env://")


def make_mesh(sizes: tuple) -> Mesh:
    """The mesh of ``sizes`` over every rank of the initialised world:
    ("data", "model") for two sizes, ("pod", "data", "model") for three.
    Every rank creates every group in the same order (``dist.new_group``
    requires it; a rank that did otherwise would wait at the group's
    timeout): the model-axis groups (one per batch row), then the
    data-axis groups (one per pod and model column), then, with a pod
    axis above 1, the batch groups (one per model column).  A single
    process without a process group is a world of one."""
    sizes = tuple(int(s) for s in sizes)
    if len(sizes) not in (2, 3):
        raise ValueError(f"a mesh of 2 or 3 axes, not {sizes}")
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                        "model")
    pods, data, model = (1,) * (3 - len(sizes)) + sizes
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world != pods * data * model:
        raise ValueError(f"the mesh {sizes} over {names} needs a world "
                         f"of {pods * data * model} ranks; this world has "
                         f"{world}")
    if not dist.is_initialized():
        return Mesh(names, sizes, None, rank)
    everyone = dist.group.WORLD

    def groups(all_ranks: list) -> Optional[Any]:
        """One group per member list, this rank's returned; the world
        itself for one group, None for groups of one rank."""
        if len(all_ranks) == 1:
            return everyone
        mine = None
        for ranks in all_ranks:
            if len(ranks) == 1:
                continue
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    rows = pods * data
    group = groups([list(range(r * model, (r + 1) * model))
                    for r in range(rows)])
    data_group = groups([[(p * data + d) * model + c for d in range(data)]
                         for p in range(pods) for c in range(model)])
    batch_group = data_group
    if pods > 1:
        batch_group = groups([list(range(c, world, model))
                              for c in range(model)])
    return Mesh(names, sizes, group, rank, data_group=data_group,
                world=everyone, batch_group=batch_group)


def make_host_mesh(model: int = 1) -> Mesh:
    """The ("data", "model") mesh over every rank of the initialised
    world: each data row's ``model`` ranks one model-axis group, each
    model column's ``world // model`` ranks one data-axis group
    (``make_mesh``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model <= 0 or world % model:
        raise ValueError(f"--mesh-model {model} does not divide the "
                         f"{world} ranks of the world")
    return make_mesh((world // model, model))


def data_axes(mesh: Mesh) -> tuple:
    """The batch-sharding axes of a mesh: ("pod", "data") or ("data",)."""
    return tuple(n for n in mesh.axis_names if n != "model")


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


def _rank_main(rank: int, n: int, job_file: str, backend: str,
               init_file: str, timeout_s: float, results) -> None:
    try:
        with open(job_file, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable, n: int, args: tuple = (), *, init_file: str,
                backend: str = "gloo", timeout_s: float = 60.0,
                join_s: Optional[float] = None) -> list:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes, each in one
    process group of world size ``n`` (``backend``, a ``file://`` store at
    ``init_file``, which must not exist yet; collectives time out after
    ``timeout_s``).  ``fn`` must be importable by name and its results
    picklable; ``fn`` and ``args`` reach the ranks through a file beside
    the store (a pipe would hold each start until its rank has read
    them).  Waits at most ``join_s`` seconds (default: no limit) for
    every rank, then kills what is left.  Returns the results in rank
    order; raises ``RuntimeError`` with the failing ranks' tracebacks if
    a rank raised, died or ran out of time."""
    if os.path.exists(init_file):
        raise ValueError(f"the store {init_file} exists: a stale world")
    job_file = init_file + ".job"
    with open(job_file, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, job_file, backend, init_file,
                               timeout_s, results)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = None if join_s is None else time.monotonic() + join_s
    got: dict = {}

    def take(timeout: float) -> bool:
        try:
            rank, ok, out = results.get(timeout=timeout)
        except queue_mod.Empty:
            return False
        got[rank] = (ok, out)
        return True

    try:
        while len(got) < n:
            if take(1.0):
                continue
            dead = all(p.exitcode is not None
                       for r, p in enumerate(procs) if r not in got)
            late = deadline is not None and time.monotonic() > deadline
            if dead or late:
                while len(got) < n and take(0.5):  # what is still in flight
                    pass
                break
    finally:
        for p in procs:
            p.join(timeout=5.0 if len(got) == n else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}: {out}" for r, (ok, out) in sorted(got.items())
              if not ok]
    missing = [r for r in range(n) if r not in got]
    if missing:
        errors.append(f"ranks {missing} gave no result (exit codes "
                      f"{[procs[r].exitcode for r in missing]})")
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    return [got[r][1] for r in range(n)]


def run_jobs(rank: int, jobs: list) -> list:
    """Several rank functions in one world, in order, for ``spawn_ranks``:
    ``jobs`` holds (fn, job) pairs, each ``fn(rank, job)`` importable by
    name (``serve.serve_shard``, ``serve.split_decode_shard``)."""
    return [fn(rank, job) for fn, job in jobs]
