"""Bringing up the ranks: multi-host initialisation, the host-major pod
mesh, and a launcher for one machine; the counterpart of
``sparsetpu/dist/multihost.py``.

BASELINE config 5 runs the A^7 chain on two or more hosts: each host owns
a block of rows and B's panels ride the ring (``dist/panels.py``).  Every
function of ``dist/`` works on any mesh, so what is particular to several
hosts is the runtime's initialisation and a mesh whose row blocks keep each
host's ranks together.  The port runs one rank a process and one card a
rank: JAX's process (a host with its devices) becomes a group of ranks.

``run_local`` starts a world of ranks on this machine, each in a process of
its own, and is what the tests, ``bench/scaling.py``, ``entry.py`` and
``chip_smoke.py`` run their rank programs (``dist/programs.py``) through.

Run as ``python -m sparsetpu_torch.dist.multihost [--device cpu]`` with
only the ``SPARSETPU_COORD`` / ``SPARSETPU_NPROC`` / ``SPARSETPU_PID``
variables set, one process a rank, each process shards the ESC A^2 of a
small torus over the world and checks its own block against the host
oracle.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import queue
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..csr import DEFAULT_DEVICE, resolve_device
from .shard import default_mesh

RUN_TIMEOUT_S = 1800.0  # a world that has not answered by then is stopped
FAIL_GRACE_S = 20.0     # how long the other ranks of a failed one may still answer
LOOPBACK = "lo"         # the interface run_local's ranks talk over


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=DEFAULT_DEVICE) -> None:
    """Bring up the default process group (idempotent).

    The arguments default to the variables a hand-launched cluster sets:

        SPARSETPU_COORD=host0:1234 SPARSETPU_NPROC=2 SPARSETPU_PID=0 \\
            python -m sparsetpu_torch.dist.multihost

    The coordinator is a ``host:port`` (a TCP store on rank 0's side) or
    any ``torch.distributed`` init URL (``file://...``, ``tcp://...``).
    With no coordinator and no process count this is a single process and
    nothing is done.  The ranks first meet through the coordinator's store
    and count the ranks on each host; the backend is ``world_backend``'s
    for this host's count, as in ``run_local``: NCCL where every rank of
    the host has a card of its own, gloo where ranks share a card (CUDA
    tensors staged through host memory) or run on the CPU.  The host's
    i-th rank takes card i modulo its cards.  ``device`` is the card
    unless the caller asks for the CPU; with no card present, the card
    raises."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("SPARSETPU_COORD")
    if num_processes is None and "SPARSETPU_NPROC" in os.environ:
        num_processes = int(os.environ["SPARSETPU_NPROC"])
    if process_id is None and "SPARSETPU_PID" in os.environ:
        process_id = int(os.environ["SPARSETPU_PID"])
    if coordinator_address is None and num_processes is None:
        return  # a single process: nothing to bring up
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator, the process count "
                         "and this process's id (SPARSETPU_COORD, SPARSETPU_NPROC, "
                         "SPARSETPU_PID)")
    device = resolve_device(device)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    store, _, _ = next(dist.rendezvous(init, rank=process_id, world_size=num_processes))
    host = socket.gethostname()
    store.set(f"sparsetpu/host/{process_id}", host)
    hosts = [store.get(f"sparsetpu/host/{r}").decode() for r in range(num_processes)]
    on_host = [r for r, h in enumerate(hosts) if h == host]
    backend = world_backend(len(on_host), device)
    card = None
    if device.type == "cuda":
        card = torch.device("cuda", on_host.index(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(card)
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id,
                            device_id=card if backend == "nccl" else None)


def _host_order(hosts: List[str]) -> List[int]:
    """Ranks sorted host-major: each host in the order of its first rank,
    ranks in order within a host."""
    first = {}
    for r, h in enumerate(hosts):
        first.setdefault(h, r)
    return sorted(range(len(hosts)), key=lambda r: (first[hosts[r]], r))


def pod_mesh() -> DeviceMesh:
    """1-D mesh over every rank of every host, host-major, so a row-sharded
    matrix keeps each host's row block contiguous: ring neighbours share a
    host except at one hop a host boundary.  The launch must number each
    host's ranks consecutively, as ``torchrun`` does (JAX sorts its devices
    by process instead; a mesh here in another order than the ranks' would
    gather shards out of order), else ValueError."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call initialize() first")
    hosts: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    order = _host_order(hosts)
    if order != list(range(len(hosts))):
        raise ValueError(f"ranks are not numbered host-major: hosts by rank {hosts}")
    return default_mesh(len(hosts))


def host_row_block(n_rows: int) -> tuple:
    """(start, stop) of this process's rows under ``pod_mesh`` sharding:
    equal blocks of ceil(n_rows / ranks), one rank a process; the whole
    range in a single process."""
    if not dist.is_initialized():
        return (0, n_rows)
    per = -(-n_rows // dist.get_world_size())
    rank = dist.get_rank()
    return (min(rank * per, n_rows), min((rank + 1) * per, n_rows))


def _to_numpy(x):
    """Tensors in a rank's result, at any depth of tuples, lists and dicts,
    as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def _rank_main(rank: int, world: int, backend: str, device_type: str, init_method: str,
               results, fn: Callable, args: tuple) -> None:
    """One rank of ``run_local``'s world: its device, the process group, the
    program, its result (or traceback) on the queue."""
    try:
        # the world lives on this machine: its sockets stay on the loopback
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, LOOPBACK)
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                device_id=device if backend == "nccl" else None)
        try:
            out = _to_numpy(fn(device, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def world_backend(n_ranks: int, device=DEFAULT_DEVICE) -> str:
    """The backend of a world with ``n_ranks`` ranks on this machine (the
    one rule of ``run_local`` and ``initialize``): NCCL where every rank has
    a card of its own, gloo where ranks share a card (NCCL refuses two ranks
    on one device) or run on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def run_local(fn: Callable, n_ranks: int, *args, device=DEFAULT_DEVICE,
              verbose: bool = True) -> List[Any]:
    """Run ``fn(device, *args)`` on every rank of a fresh world of
    ``n_ranks`` processes on this machine and return each rank's result, in
    rank order, with its tensors as numpy arrays.

    ``fn`` is pickled by its import path, so it must be a module-level
    function of a module the children can import without jax (the port's
    ``dist/programs.py``).  The children start by ``spawn`` (a parent that
    has initialised CUDA cannot fork) and meet through a ``file://`` store
    in a temporary directory, so parallel worlds never race for a TCP port.
    The backend is ``world_backend``'s, printed when ``verbose``; rank r
    takes card r modulo the cards present.  A rank's exception is raised
    here with its traceback, after every rank has stopped."""
    device = resolve_device(device)
    backend = world_backend(n_ranks, device)
    if verbose:
        shared = ("ranks share one card" if device.type == "cuda" and backend == "gloo"
                  else "one card a rank" if device.type == "cuda" else "host memory")
        print(f"run_local: {n_ranks} rank(s) on {device.type} over {backend} ({shared})",
              flush=True)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="sparsetpu_world_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_ranks, backend, device.type, init, results, fn, args))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        got, failed = {}, {}
        deadline = time.monotonic() + RUN_TIMEOUT_S
        first_failure = None
        try:
            while len(got) + len(failed) < n_ranks:
                now = time.monotonic()
                # ranks left waiting in a collective for a failed one are stopped
                if now > deadline or (first_failure and now - first_failure > FAIL_GRACE_S):
                    break
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if p.exitcode not in (None, 0) and r not in got and r not in failed:
                            failed[r] = f"the process ended with exit code {p.exitcode}"
                    first_failure = first_failure or (now if failed else None)
                    continue
                if ok:
                    got[rank] = out
                else:
                    failed[rank] = out
                    first_failure = first_failure or now
        finally:
            for p in procs:
                p.join(timeout=30 if not failed else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed or len(got) < n_ranks:
        detail = (f"rank {min(failed)} failed:\n{failed[min(failed)]}" if failed
                  else f"ranks {sorted(set(range(n_ranks)) - set(got))} gave no result "
                       f"within {RUN_TIMEOUT_S:.0f} s")
        raise RuntimeError(f"run_local ({n_ranks} ranks): {detail}")
    return [got[r] for r in range(n_ranks)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    """One process of a multi-process run wired only through the
    ``SPARSETPU_*`` variables: initialise, build the pod mesh, shard the
    thinned 4^3 torus, compute its ESC A^2 sharded and check this rank's
    block against the host oracle.  ``--device cpu`` runs it on the host;
    by default it runs on the card and raises where there is none."""
    from ..csr import SparseCSR
    from ..graphs import generate
    from ..ops.spgemm import pow2
    from ..semiring import U64
    from ..utils import oracle
    from . import shard as dshard

    parser = argparse.ArgumentParser(prog="python -m sparsetpu_torch.dist.multihost",
                                     description="one process of an env-wired run")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    initialize(device=args.device)
    if not dist.is_initialized():
        raise SystemExit("set SPARSETPU_COORD, SPARSETPU_NPROC and SPARSETPU_PID")
    rank, nd = dist.get_rank(), dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device())
              if resolve_device(args.device).type == "cuda" else torch.device("cpu"))
    mesh = pod_mesh()
    rows, cols, vals, n = generate.thin(generate.lattice([4, 4, 4], torus=True), 0.3, seed=7)
    a = SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64, device=device)
    s = dshard.shard(a, nd, mesh=mesh)
    start, stop = host_row_block(n)
    if (start, stop) != (min(rank * s.n_local, n), min((rank + 1) * s.n_local, n)):
        raise RuntimeError(f"host_row_block {start, stop} is not shard {rank}'s rows")
    cap = pow2(int(dshard.symbolic_flops_sharded(s, a, mesh=mesh).max()))
    c = dshard.spgemm_sharded(s, a, expand_cap=cap, mesh=mesh)
    amap = oracle.coo_to_dict((rows, cols, vals, n))
    want = np.zeros((c.n_local, n), np.uint64)
    for (r, col), v in oracle.matmul(amap, amap).items():
        if start <= r < stop:
            want[r - start, col] = v
    if not np.array_equal(c.local().check().to_dense_numpy(), want):
        raise RuntimeError(f"rank {rank}: rows [{start}, {stop}) disagree with the oracle")
    print(f"MULTIHOST_OK pid={rank} ranks={nd} rows=[{start},{stop}) "
          f"nnz_total={c.total_nnz(mesh)} backend={dist.get_backend()} device={device}",
          flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
    sys.exit(0)
