"""The port's multi-process bring-up (``paddle_tpu_torch.distributed``)
against the reference's contract (``tests/test_distributed_launch.py``):
two gloo processes join through ``init_multihost`` and all-reduce; a bad
process id is refused up front; a rendezvous that times out names its
coordinator; a single process is a no-op."""

import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import launch

from torch_ranks import RankPool, _free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def test_two_gloo_ranks_all_reduce(pool):
    assert pool.run("rank_info") == [(0, 2, "gloo"), (1, 2, "gloo")]
    x = np.arange(6, dtype=np.float32)
    for got in pool.run("all_reduce_sum", x):
        np.testing.assert_array_equal(got, x * 3)   # x*1 + x*2


def test_single_process_is_a_noop(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_COORDINATOR", raising=False)
    assert launch.init_multihost() == (0, 1)
    assert not launch.multihost_active()
    assert launch.shutdown_multihost() is False


@pytest.mark.parametrize("pid,n", [(2, 2), (-1, 2), (5, 3)])
def test_bad_process_id_rejected_up_front(pid, n):
    with pytest.raises(ValueError, match="out of range"):
        launch.init_multihost("localhost:1", num_processes=n,
                              process_id=pid, device="cpu")
    assert not launch.multihost_active()


def test_bad_num_processes_rejected(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_COORDINATOR", "localhost:1")
    monkeypatch.setenv("PADDLE_TPU_NUM_PROCS", "0")
    with pytest.raises(ValueError, match="num_processes must be >= 1"):
        launch.init_multihost(device="cpu")


def test_nccl_without_cuda_raises_instead_of_gloo():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: NCCL would be taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.init_multihost("localhost:1", num_processes=2,
                              process_id=0)


def test_timeout_names_the_coordinator():
    """Rank 1 of 2 with no rank 0 behind the address: the rendezvous
    times out and the error names the coordinator (in a child process,
    which this one's process group would otherwise collide with)."""
    addr = "localhost:%d" % _free_port()
    code = ("from paddle_tpu_torch.distributed import init_multihost\n"
            "try:\n"
            "    init_multihost(%r, 2, 1, initialization_timeout_sec=2,"
            " device='cpu')\n"
            "except RuntimeError as e:\n"
            "    print('ERR', e)\n" % addr)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]]
                  if os.environ.get("PYTHONPATH") else [])))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert "ERR" in out.stdout, out.stdout + out.stderr
    assert addr in out.stdout and "timeout 2" in out.stdout


def test_elastic_names_raise_with_their_item():
    """The elastic control plane's names are the ported modules' (the
    reference's names, and the port's abort beside them); a name never
    ported raises AttributeError."""
    import paddle_tpu.distributed as ref_dist
    from paddle_tpu_torch.distributed import elastic, master
    assert tdist.ElasticTrainerLoop is elastic.ElasticTrainerLoop
    assert tdist.MasterServer is master.MasterServer
    ref_names = {n for n in dir(ref_dist) if not n.startswith("_")} - {
        "elastic", "master", "launch"}
    assert set(tdist.__all__) == ref_names | {"abort_multihost"}
    for name in tdist.__all__:
        getattr(tdist, name)
    with pytest.raises(AttributeError):
        tdist.nothing_here
