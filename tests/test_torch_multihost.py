"""The port's multi-host wiring (sparsetpu_torch.dist.multihost), on the
CPU: the counterparts of tests/test_multihost.py's cases.

A single process needs no process group; a two-process run is wired only
through the SPARSETPU_* variables (two ``python -m
sparsetpu_torch.dist.multihost --device cpu`` processes meeting through a
``file://`` store; a cuda-marked run of the same on the card); the pod
mesh, the row blocks and the ring on the pod mesh run in one gloo world of
two ranks (``run_local``).  Tolerance: exact, against
numpy's int64 product of the same seeded graph.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sparsetpu.graphs import generate as jgen

from sparsetpu_torch.dist import multihost, programs, run_local

from test_torch_dist import whole_dense

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 1000


def _graph():
    return jgen.thin(jgen.lattice([4, 4, 4], torus=True), 0.3, seed=7)


def _a_squared():
    rows, cols, vals, n = _graph()
    a = np.zeros((n, n), np.int64)
    np.add.at(a, (rows, cols), vals.astype(np.int64))
    return a @ a


@pytest.fixture(scope="module")
def pod():
    return run_local(programs.pod_cases, 2, N_ROWS, programs.coo_arrays(_graph()),
                     device="cpu", verbose=False)


def test_initialize_single_process_noop(monkeypatch):
    for k in ("SPARSETPU_COORD", "SPARSETPU_NPROC", "SPARSETPU_PID"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()  # no coordinator configured -> no-op
    assert not dist.is_initialized()
    assert multihost.host_row_block(N_ROWS) == (0, N_ROWS)


def test_initialize_needs_the_whole_wiring(monkeypatch):
    """A coordinator without a process count and id is a wiring fault."""
    monkeypatch.setenv("SPARSETPU_COORD", "localhost:1")
    monkeypatch.delenv("SPARSETPU_NPROC", raising=False)
    monkeypatch.delenv("SPARSETPU_PID", raising=False)
    with pytest.raises(ValueError, match="SPARSETPU_NPROC"):
        multihost.initialize()
    assert not dist.is_initialized()


def test_initialize_without_a_card_raises(monkeypatch, tmp_path):
    """The card is the default device: with none present, a wired run
    raises before it meets the other ranks, unless the caller asks for the
    CPU."""
    monkeypatch.setenv("SPARSETPU_COORD", f"file://{tmp_path / 'store'}")
    monkeypatch.setenv("SPARSETPU_NPROC", "2")
    monkeypatch.setenv("SPARSETPU_PID", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.initialize()
    assert not dist.is_initialized()


def _two_process_run(tmp_path, device):
    """Two ``python -m sparsetpu_torch.dist.multihost --device <device>``
    processes wired through SPARSETPU_COORD / NPROC / PID only; each shards
    the ESC A^2 over the pair and checks its own rows against the host
    oracle.  Returns each process's output after checking its exit code
    and its total nnz against numpy's."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("SPARSETPU_")}
    env["SPARSETPU_COORD"] = f"file://{tmp_path / 'store'}"
    env["SPARSETPU_NPROC"] = "2"
    procs = [subprocess.Popen([sys.executable, "-m", "sparsetpu_torch.dist.multihost",
                               "--device", device],
                              cwd=REPO, env={**env, "SPARSETPU_PID": str(pid)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    want = np.count_nonzero(_a_squared())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"MULTIHOST_OK pid={pid} ranks=2" in out and f"nnz_total={want}" in out, out
    return outs


def test_two_process_run_wired_by_environment(tmp_path):
    """Two processes through SPARSETPU_COORD / NPROC / PID only, on the
    CPU over gloo; the total nnz is numpy's."""
    for out in _two_process_run(tmp_path, "cpu"):
        assert "backend=gloo device=cpu" in out, out


@pytest.mark.cuda
def test_two_process_run_wired_by_environment_on_the_card(tmp_path):
    """The same run on the card: two processes on one card take gloo and
    stage through host memory (NCCL refuses two ranks on one device), one
    card each take NCCL, as ``world_backend`` says."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    backend = multihost.world_backend(2, "cuda")
    for pid, out in enumerate(_two_process_run(tmp_path, "cuda")):
        card = pid % torch.cuda.device_count()
        assert f"backend={backend} device=cuda:{card}" in out, out


def test_host_row_block_covers_rows(pod):
    blocks = sorted(r["row_block"] for r in pod)
    assert blocks[0][0] == 0 and blocks[-1][1] == N_ROWS
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert [r["row_block"] for r in pod] == blocks  # rank order is row order


def test_pod_mesh_orders_host_major(pod):
    for r in pod:
        assert r["mesh"] == [0, 1] and len(r["hosts"]) == 2
    assert multihost._host_order(["h0", "h1", "h0", "h1"]) == [0, 2, 1, 3]
    assert multihost._host_order(["h1", "h1", "h0"]) == [0, 1, 2]


def test_panel_ring_on_pod_mesh(pod):
    """The ring runs unchanged on the pod mesh: the same code on one host
    or several."""
    for r in pod:
        np.testing.assert_array_equal(whole_dense(r["whole"], 64), _a_squared())
