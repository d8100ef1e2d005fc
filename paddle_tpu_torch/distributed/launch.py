"""Multi-process bring-up (reference ``paddle_tpu/distributed/launch.py``)
over ``torch.distributed.init_process_group``.

One coordinator address, a process count and this process's id, from
the arguments or the reference's environment variables; NCCL when the
process runs on the card (the default), gloo when the caller asks for
the CPU. Every rank then takes part in the meshes of
``paddle_tpu_torch.parallel``.
"""

import datetime
import math
import os

import torch

__all__ = ["init_multihost", "shutdown_multihost", "multihost_active"]

# whether THIS module initialized the process group (so
# shutdown_multihost knows there is something to tear down)
_active = False


def multihost_active():
    return _active


def _init_method(address):
    return address if "://" in address else "tcp://" + address


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, initialization_timeout_sec=None,
                   device=None):
    """Initialize the default process group from the arguments or the
    env vars PADDLE_TPU_COORDINATOR (``host:port``) /
    PADDLE_TPU_NUM_PROCS / PADDLE_TPU_PROC_ID. On a single process (no
    coordinator) this is a no-op. Returns (process_id, num_processes).

    ``device`` picks the backend: None or a CUDA device takes NCCL (and
    raises without CUDA: no fall back to gloo), ``"cpu"`` takes gloo. A
    rank on the card binds to ``cuda:<process_id % device count>``.

    ``initialization_timeout_sec`` (or env PADDLE_TPU_INIT_TIMEOUT)
    bounds the rendezvous; on expiry a RuntimeError names the
    coordinator. An invalid process_id/num_processes combination is
    rejected up front: a worker launched with process_id >=
    num_processes would otherwise wedge every OTHER worker's rendezvous
    until their timeout."""
    global _active
    coordinator_address = coordinator_address or \
        os.environ.get("PADDLE_TPU_COORDINATOR")
    if coordinator_address is None:
        return 0, 1
    num_processes = int(num_processes if num_processes is not None else
                        os.environ.get("PADDLE_TPU_NUM_PROCS", "1"))
    process_id = int(process_id if process_id is not None else
                     os.environ.get("PADDLE_TPU_PROC_ID", "0"))
    if num_processes < 1:
        raise ValueError("num_processes must be >= 1, got %d"
                         % num_processes)
    if not 0 <= process_id < num_processes:
        raise ValueError(
            "process_id %d out of range for num_processes %d "
            "(valid: 0..%d)" % (process_id, num_processes,
                                num_processes - 1))
    if initialization_timeout_sec is None:
        env = os.environ.get("PADDLE_TPU_INIT_TIMEOUT")
        initialization_timeout_sec = float(env) if env else None
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for an NCCL process group: pass "
                "device='cpu' for gloo")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kwargs = {}
    if initialization_timeout_sec is not None:
        # round UP: a sub-second bound would otherwise become 0
        kwargs["timeout"] = datetime.timedelta(
            seconds=max(1, math.ceil(float(initialization_timeout_sec))))
    try:
        torch.distributed.init_process_group(
            backend="gloo" if cpu else "nccl",
            init_method=_init_method(coordinator_address),
            world_size=num_processes, rank=process_id, **kwargs)
    except Exception as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed for process "
            "%d/%d against coordinator %s%s: %s — check that the "
            "coordinator process is up, the address is reachable, and "
            "every worker was launched with a distinct process_id"
            % (process_id, num_processes, coordinator_address,
               " (timeout %ss)" % initialization_timeout_sec
               if initialization_timeout_sec is not None else "",
               e)) from e
    _active = True
    return process_id, num_processes


def shutdown_multihost():
    """Tear down the process group if this process brought it up
    (idempotent, exception-safe)."""
    global _active
    if not _active:
        return False
    try:
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001 — teardown of a wedged group
        pass
    _active = False
    return True
