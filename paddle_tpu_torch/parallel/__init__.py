"""SPMD parallelism over ``torch.distributed`` process groups (reference
``paddle_tpu/parallel/__init__.py``).

The reference is single-controller: one process drives every device and
GSPMD gives each op global-view semantics. Here there is one process a
rank (multi-controller), and the reference's API and numbers are kept:

* every rank runs the same script and feeds ``Executor.run`` the GLOBAL
  batch; each rank places only its own rows (``shard_feed``, the
  reference's ``_scatter_host``), and a batch-sharded fetch is
  all-gathered, so every rank's fetch is the global value;
* parameters and optimizer slots follow ``param_rules`` (first match
  wins): each rank stores its own slice, the step gathers it, and the
  update writes the slice back. Unmatched state is replicated, and state
  a run creates is broadcast from the mesh's first rank, so every rank
  starts from one set of weights;
* ops compute on the local rows; the ops that mix rows (the batch
  reductions, batch-norm statistics, metrics) reduce over the data
  axis's process group (``parallel/spmd.py``), and the gradients of
  replicated state are summed over it.

A :class:`Mesh` is a grid of ranks with named axes (the reference's
``jax.sharding.Mesh`` over devices) and one process group per line of
each axis. Without an initialized process group a mesh of one rank
needs none: its collectives are identities.
"""

import logging
import re

import numpy as np
import torch

__all__ = ["Mesh", "P", "make_mesh", "DistStrategy", "DataParallel",
           "ring_attention", "dense_attention", "current_strategy",
           "set_current_strategy", "resize_strategy"]

_log = logging.getLogger("paddle_tpu_torch")

_current_strategy = None


def set_current_strategy(strategy):
    """Run-time strategy context (set by the Executor around a run, so
    mesh-aware ops such as ring attention and the distributed lookup
    find the mesh). Returns the previous one."""
    global _current_strategy
    prev = _current_strategy
    _current_strategy = strategy
    return prev


def current_strategy():
    return _current_strategy


class P(tuple):
    """A partition spec: one mesh axis name (or None) per array
    dimension, the reference's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return tuple.__new__(cls, axes)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


def _world():
    """(rank, world size, initialized) of the default process group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


class Mesh:
    """Ranks laid out on named axes. ``shape`` maps each axis to its
    size and ``devices`` is the rank grid (numpy), as the reference's
    mesh holds its devices. ``group(axis)`` is the process group of this
    rank's line along ``axis`` (None without a process group), and
    ``coord(axis)`` this rank's index on it."""

    def __init__(self, ranks, axis_names):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank, _, init = _world()
        where = np.argwhere(self.devices == self.rank)
        self.in_mesh = bool(len(where))
        self._coord = dict(zip(self.axis_names, where[0])) \
            if self.in_mesh else {}
        self._groups = {}
        self.mesh_group = None
        if init:
            # every rank creates every group, in one order (new_group is
            # collective over the default group)
            dist = torch.distributed
            self.mesh_group = dist.new_group(
                ranks=sorted(int(r) for r in self.devices.reshape(-1)))
            for d, axis in enumerate(self.axis_names):
                lines = np.moveaxis(self.devices, d, -1).reshape(
                    -1, self.devices.shape[d])
                for line in lines:
                    g = dist.new_group(ranks=[int(r) for r in line])
                    if self.rank in line:
                        self._groups[axis] = g

    def size(self, axis):
        return int(self.shape.get(axis, 1)) if axis is not None else 1

    def coord(self, axis):
        return int(self._coord.get(axis, 0)) if axis is not None else 0

    def group(self, axis):
        return self._groups.get(axis)

    def first_rank(self):
        return int(self.devices.reshape(-1)[0])

    def __repr__(self):
        return "Mesh(%r)" % (self.shape,)


def make_mesh(axes, devices=None):
    """axes: dict name -> size, e.g. {'data': 4, 'model': 2}, over the
    ranks ``devices`` (default: every rank of the process group, or the
    one process)."""
    rank, world, _ = _world()
    devices = list(devices) if devices is not None else list(range(world))
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError("mesh wants %d devices, have %d"
                         % (n, len(devices)))
    return Mesh(np.array(devices[:n]).reshape(sizes), names)


class DistStrategy:
    """Sharding policy handed to the Executor.

    param_rules: list of (regex, P) — first match wins; unmatched
    persistable state is replicated. data_axis shards every feed's batch
    (0th) dim; model_axis names the tensor-parallel axis for mesh-aware
    ops (multi-head attention splits its heads over it).
    """

    _uid_counter = [0]
    _scatter_fallback_logged = False
    _packed_fallback_logged = False

    def __init__(self, mesh, data_axis="data", param_rules=None,
                 model_axis="model"):
        self.mesh = mesh
        self.data_axis = data_axis if data_axis in mesh.axis_names else None
        self.model_axis = model_axis if model_axis in mesh.axis_names \
            else None
        self.param_rules = [(re.compile(pat), spec)
                            for pat, spec in (param_rules or [])]
        # monotonic uid for executor cache keys (id() can be reused)
        DistStrategy._uid_counter[0] += 1
        self._uid = DistStrategy._uid_counter[0]

    def data_shards(self):
        """Size of the data axis (1 = no batch sharding): how many ways
        the staging thread splits a packed batch."""
        return self.mesh.size(self.data_axis)

    def data_coord(self):
        """This rank's shard of the batch."""
        return self.mesh.coord(self.data_axis)

    def replicated(self):
        return P()

    def feed_sharding(self, name, ndim):
        if self.data_axis is None or ndim == 0:
            return self.replicated()
        return P(self.data_axis, *([None] * (ndim - 1)))

    def state_sharding(self, name, ndim, shape=None, dist_rows=None):
        """The spec of persistable ``name``. dist_rows: {var name ->
        padded row count} of distributed embedding tables (and their
        row-shaped optimizer slots) to row-shard over the data axis,
        which the executor passes when ``embedding_shard_rows`` is
        armed: shard s then holds the rows with id = s (mod n)."""
        if dist_rows and name in dist_rows and ndim >= 1 and \
                self.data_axis is not None and shape is not None and \
                shape[0] == dist_rows[name] and \
                shape[0] % self.data_shards() == 0:
            return P(self.data_axis, *([None] * (ndim - 1)))
        for pat, spec in self.param_rules:
            if pat.search(name):
                spec_t = tuple(spec)
                if len(spec_t) < ndim:
                    spec_t = spec_t + (None,) * (ndim - len(spec_t))
                spec_t = spec_t[:ndim]
                if shape is not None:
                    # drop axes the dim does not divide (a [1] beta-pow
                    # accumulator whose name matches a table's rule)
                    spec_t = tuple(
                        a if a is None or shape[d] % self.mesh.size(a) == 0
                        else None for d, a in enumerate(spec_t))
                return P(*spec_t)
        return self.replicated()

    def local_index(self, spec, shape):
        """The slices of a ``shape`` array that this rank holds under
        ``spec``."""
        idx = []
        for d, n in enumerate(shape):
            a = spec[d] if d < len(spec) else None
            k = self.mesh.size(a)
            if a is None or k == 1:
                idx.append(slice(None))
            else:
                step = n // k
                c = self.mesh.coord(a)
                idx.append(slice(c * step, (c + 1) * step))
        return tuple(idx)

    def shard_feed(self, name, array):
        """This rank's rows of a host array (the reference's per-shard
        placement), as a tensor; a 0-d array, or a batch the data axis
        does not divide, is replicated, which is logged once."""
        t = array if isinstance(array, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(array))
        n = self.data_shards()
        if t.dim() == 0 or n == 1:
            return t
        if t.shape[0] % n:
            if not DistStrategy._scatter_fallback_logged:
                DistStrategy._scatter_fallback_logged = True
                _log.warning(
                    "feed %r has %d rows, which the %d-way data axis does "
                    "not divide; replicating it (logged once)", name,
                    t.shape[0], n)
            return t
        return t[self.local_index(self.feed_sharding(name, t.dim()),
                                  t.shape)]

    def scatter_packed(self, buf):
        """This rank's rows of a packed ingest block (shards,
        shard_nbytes): row s goes to data shard s. Returns (rows, index
        of this rank's first row or None when replicated).

        Shard-count-change-safe: a batch packed for an OLD shard count
        still scatters when its row count divides by the data axis (k
        rows a rank); an indivisible count, e.g. 3 packed rows on a
        2-way axis, is replicated instead, which is logged once (the
        replicated copy re-pays the bytes the scatter avoids)."""
        n = self.data_shards()
        if self.data_axis is not None and buf.shape[0] % n == 0:
            k = buf.shape[0] // n
            c = self.data_coord()
            return buf[c * k:(c + 1) * k], c * k
        if self.data_axis is not None and buf.shape[0] > 1 and \
                not DistStrategy._packed_fallback_logged:
            DistStrategy._packed_fallback_logged = True
            _log.warning(
                "packed batch has %d shard rows but the mesh data axis "
                "is %d-way (resized mesh?); replicating the block "
                "(logged once)", buf.shape[0], n)
        return buf, None

    def shard_state(self, name, array, dist_rows=None):
        """This rank's slice of persistable ``name`` (a host array or a
        tensor)."""
        shape = tuple(np.shape(array))
        spec = self.state_sharding(name, len(shape), shape, dist_rows)
        return array[self.local_index(spec, shape)]

    def gather(self, tensor, spec):
        """The global array of a rank's slice ``tensor`` under ``spec``
        (all-gathered over each sharded dimension's axis)."""
        from . import spmd
        for d, a in enumerate(spec):
            if a is not None and self.mesh.size(a) > 1:
                tensor = spmd.all_gather(tensor, self.mesh.group(a), dim=d)
        return tensor

    def __repr__(self):
        return "DistStrategy(%r, data_axis=%r, model_axis=%r)" % (
            self.mesh, self.data_axis, self.model_axis)


from .ring_attention import ring_attention, dense_attention  # noqa: E402


def resize_strategy(strategy, devices=None):
    """Rebuild a strategy's mesh over the CURRENT (possibly resized) set
    of ranks, the elastic-resume primitive: non-data axes (a 2-way model
    axis) keep their extent, the data axis absorbs the change. Returns a
    NEW DistStrategy (fresh uid, so executor cache entries re-key) with
    the original's param rules."""
    _, world, _ = _world()
    devices = list(devices) if devices is not None else list(range(world))
    old_sizes = dict(strategy.mesh.shape)
    fixed = {a: s for a, s in old_sizes.items()
             if a != strategy.data_axis}
    fixed_total = int(np.prod(list(fixed.values()))) if fixed else 1
    if len(devices) < fixed_total:
        raise ValueError(
            "resize needs at least %d devices for the non-data axes "
            "%r, have %d" % (fixed_total, fixed, len(devices)))
    axes = {}
    for a in strategy.mesh.axis_names:  # preserve axis order
        if a == strategy.data_axis:
            axes[a] = len(devices) // fixed_total
        else:
            axes[a] = old_sizes[a]
    used = int(np.prod(list(axes.values())))
    if used < len(devices):
        _log.warning(
            "resize_strategy: mesh %r uses %d of %d surviving devices "
            "(%d stranded by the non-data axes %r)",
            axes, used, len(devices), len(devices) - used, fixed)
    mesh = make_mesh(axes, devices)
    return DistStrategy(
        mesh, data_axis=strategy.data_axis or "data",
        model_axis=strategy.model_axis or "model",
        param_rules=[(pat.pattern, spec)
                     for pat, spec in strategy.param_rules])


def DataParallel(mesh=None, n_devices=None, param_rules=None):
    """Pure data parallelism over all (or n) ranks."""
    if mesh is None:
        n = n_devices or _world()[1]
        mesh = make_mesh({"data": n})
    return DistStrategy(mesh, data_axis="data", param_rules=param_rules)

