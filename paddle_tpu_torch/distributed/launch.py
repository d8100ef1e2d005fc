"""Multi-process bring-up (reference ``paddle_tpu/distributed/launch.py``)
over ``torch.distributed.init_process_group``.

One coordinator address, a process count and this process's id, from
the arguments or the reference's environment variables; NCCL when the
process runs on the card (the default), gloo when the caller asks for
the CPU. Every rank then takes part in the meshes of
``paddle_tpu_torch.parallel``.

The elastic runtime (``elastic.py``) brings a group up once for each
membership generation: ``init_multihost(..., generation=G)`` keys the
group's rendezvous under a ``gen<G>/`` prefix of one TCP store that the
process keeps (the loop passes ``"<G>.<n>"``, the n-th bring-up at G),
so no bring-up reads another's keys, and
:func:`abort_multihost` aborts a group that may be wedged instead of
destroying it (see its docstring).
"""

import ctypes
import datetime
import math
import os
import threading

import torch

__all__ = ["init_multihost", "shutdown_multihost", "multihost_active",
           "abort_multihost"]

# whether THIS module initialized the process group (so
# shutdown_multihost knows there is something to tear down)
_active = False
# the TCP store of each coordinator address an elastic group rendezvoused
# at, kept for the life of the process: rank 0's holds the server, which
# every later generation's group reaches under its own prefix
_stores = {}


def multihost_active():
    return _active


def _init_method(address):
    return address if "://" in address else "tcp://" + address


def _elastic_store(address, process_id, timeout, generation):
    """The ``gen<generation>/`` prefix of the process's TCP store at
    ``address`` (made at first use: the server on process 0)."""
    host, port = address.split("://")[-1].rsplit(":", 1)
    key = (host, int(port))
    store = _stores.get(key)
    if store is None:
        store = _stores[key] = torch.distributed.TCPStore(
            host, int(port), is_master=process_id == 0, timeout=timeout,
            wait_for_workers=False)
    return torch.distributed.PrefixStore("gen%s/" % generation, store)


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, initialization_timeout_sec=None,
                   device=None, generation=None):
    """Initialize the default process group from the arguments or the
    env vars PADDLE_TPU_COORDINATOR (``host:port``) /
    PADDLE_TPU_NUM_PROCS / PADDLE_TPU_PROC_ID. On a single process (no
    coordinator) this is a no-op. Returns (process_id, num_processes).

    ``device`` picks the backend: None or a CUDA device takes NCCL (and
    raises without CUDA: no fall back to gloo), ``"cpu"`` takes gloo. A
    rank on the card binds to ``cuda:<process_id % device count>`` (an
    elastic worker at its first bring-up only).

    ``initialization_timeout_sec`` (or env PADDLE_TPU_INIT_TIMEOUT)
    bounds the rendezvous and every collective of the group; on expiry a
    RuntimeError names the coordinator.

    ``generation`` (the elastic runtime's: a generation, or
    ``"<generation>.<bring-up>"``) rendezvouses under its own prefix of
    the process's store at the address instead of a ``tcp://`` init
    method. On NCCL it then turns the group's own asynchronous error
    handling off (``TORCH_NCCL_ASYNC_ERROR_HANDLING`` 0, unless set), as
    :func:`abort_multihost` needs: with it on, NCCL's watchdog would end
    the process on the error an abort leaves; and it takes NCCL's socket
    transport between the cards of a host (``NCCL_P2P_DISABLE`` and
    ``NCCL_SHM_DISABLE`` 1, unless set): through NVLink peer memory a
    peer's death is a CUDA error in every survivor ("invalid access of
    peer GPU memory"), and through shared memory an abort does not
    return. The price is the collectives' bandwidth.

    An invalid process_id/num_processes combination is rejected up
    front: a worker launched with process_id >= num_processes would
    otherwise wedge every other worker's rendezvous until their
    timeout."""
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
        if generation is None or not _stores:
            # an elastic worker keeps the card of its first bring-up: its
            # rank may change with the world, its card does not
            torch.cuda.set_device(process_id % torch.cuda.device_count())
    kwargs = {}
    if initialization_timeout_sec is not None:
        # round UP: a sub-second bound would otherwise become 0
        kwargs["timeout"] = datetime.timedelta(
            seconds=max(1, math.ceil(float(initialization_timeout_sec))))
    try:
        if generation is None:
            kwargs["init_method"] = _init_method(coordinator_address)
        else:
            if not cpu:
                os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING",
                                      "0")
                os.environ.setdefault("NCCL_P2P_DISABLE", "1")
                os.environ.setdefault("NCCL_SHM_DISABLE", "1")
            kwargs["store"] = _elastic_store(
                coordinator_address, process_id,
                kwargs.get("timeout", datetime.timedelta(seconds=300)),
                generation)
        torch.distributed.init_process_group(
            backend="gloo" if cpu else "nccl",
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


def abort_multihost(wait_sec=5.0):
    """Abort the process group if this process brought it up (idempotent,
    exception-safe, callable from any thread); returns whether there was
    one.

    ``destroy_process_group`` (and any collective before it) can block
    for good on a group whose peer died; an abort does not wait on it.
    On NCCL each group's communicators are aborted (``ncclCommAbort``),
    the newest group first, on a helper thread: the abort's flag ends a
    collective kernel waiting on a dead peer at once, so a thread blocked
    in a synchronize behind it returns and the CUDA context stays usable;
    the communicators' cleanup after it may itself wait on the dead peer,
    so it is left to the helper beyond ``wait_sec`` (0: not waited on at
    all) and the world's books are cleared here, which lets a new default
    group be made; the aborted backends are never freed (their teardown
    would wait on the dead peer, at the interpreter's exit too). A
    collective issued on an aborted group waits for good: the caller
    stops issuing them (the elastic loop's interrupt). gloo has no abort
    of a running collective: its wait ends at the group's timeout, which
    ``init_multihost`` bounds."""
    global _active
    if not _active:
        return False
    _active = False
    c10d = torch.distributed.distributed_c10d
    nccl = getattr(c10d, "ProcessGroupNCCL", None)
    backends = []
    for pg in sorted(c10d._world.pg_names, reverse=True,
                     key=lambda g: c10d._world.pg_names[g]):
        try:
            backend = pg._get_backend(torch.device("cuda"))
        except RuntimeError:
            continue             # no CUDA backend
        if nccl is not None and isinstance(backend, nccl):
            backends.append(backend)
    if not backends:
        try:
            c10d._abort_process_group()
        except Exception:  # noqa: BLE001 — a backend without abort
            _forget_groups(c10d)
        return True

    def abort_all():
        for backend in backends:
            try:
                backend.abort()
            except Exception:  # noqa: BLE001 — the others still go
                pass

    for backend in backends:
        # one reference never dropped: freeing a backend, even at the
        # interpreter's exit, runs its communicators' teardown, which can
        # wait on a dead peer for good
        ctypes.pythonapi.Py_IncRef(ctypes.py_object(backend))
    helper = threading.Thread(target=abort_all, daemon=True,
                              name="paddle-group-abort")
    helper.start()
    if wait_sec:
        helper.join(wait_sec)
    _forget_groups(c10d)
    return True


def _forget_groups(c10d):
    """Clear torch.distributed's books of every group (what
    ``_abort_process_group`` does after its aborts), without another
    abort of their communicators."""
    world = c10d._world
    c10d._update_default_pg(None)
    for name in ("pg_map", "pg_names", "pg_group_ranks", "pg_backend_config",
                 "pg_to_tag", "tags_to_pg", "pg_coalesce_state"):
        books = getattr(world, name, None)
        if books is not None:
            books.clear()
    unregister = getattr(c10d, "_unregister_all_process_groups", None)
    if unregister is not None:
        unregister()
    world.group_count = 0
