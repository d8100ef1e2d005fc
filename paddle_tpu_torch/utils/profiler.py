"""Profiler: host-side event spans and a device trace (reference
``paddle_tpu/utils/profiler.py``).

Host spans aggregate through ``utils.stat`` (a view over the metrics
registry) and record Chrome-trace events (``observability/tracing.py``);
the device trace is ``torch.profiler``'s, in place of the reference's
``jax.profiler`` trace: CUDA activity (kernels, copies) on the card, the
CPU's operators beside it.

``profiler()`` yields a :class:`ProfileHandle`; after the block exits,
``handle.report()`` returns the host event table and
``handle.chrome_trace(path)`` writes the host span trace. With
``trace_dir`` the device trace is written there as
``device_trace.json`` (Chrome trace-event JSON, Perfetto-loadable) and
the profile stays on ``handle.device_profile`` (``key_averages()``).
"""

import contextlib
import os

import torch

from ..observability import tracing as _tracing
from . import stat

__all__ = ["profiler", "ProfileHandle", "RecordEvent", "enable_profiler",
           "disable_profiler", "reset_profiler", "profile_report"]

DEVICE_TRACE = "device_trace.json"

_events = stat.StatSet("Profiler")
_enabled = [False]


def RecordEvent(name):
    """Span context. Aggregates into the profiler table while profiling
    is enabled; always records a Chrome-trace event while tracing is
    armed (the telemetry flag, or profiler()/tracing.start())."""
    if _enabled[0]:
        return _events.span(name)  # includes the trace event
    return _tracing.span(name)     # NULL_SPAN when tracing is off


def enable_profiler():
    _enabled[0] = True


def disable_profiler():
    _enabled[0] = False
    return profile_report()


def reset_profiler():
    _events.reset()


def profile_report():
    return _events.report()


class ProfileHandle:
    """Result of a ``with profiler(...) as prof:`` block.

    Inside the block the handle is live (report() shows the events so
    far); after the block it carries the final report, the captured host
    trace events, the device trace's path (``device_trace``) and the
    ``torch.profiler`` profile (``device_profile``), when ``trace_dir``
    was given.
    """

    def __init__(self, trace_dir=None):
        self.trace_dir = trace_dir
        self.device_trace = None
        self.device_profile = None
        self._report = None
        self._ts0 = _tracing.now_us()
        self._ts1 = None

    def report(self):
        """The sorted host event table (final after the block exits)."""
        return self._report if self._report is not None \
            else profile_report()

    def chrome_trace(self, path):
        """Write the host spans captured during the profiled block as
        Chrome trace-event JSON (the shared span ring buffer may hold
        older events, e.g. always-on telemetry, which are windowed out).
        The device trace, if ``trace_dir`` was given, is
        ``device_trace``."""
        return _tracing.emit_chrome_trace(path, ts_from=self._ts0,
                                          ts_to=self._ts1)


def _activities(device):
    """torch.profiler activities of a device trace: CUDA's unless the
    caller asks for the CPU (and a CUDA trace without CUDA raises)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cpu":
        return acts
    if not torch.cuda.is_available():
        raise RuntimeError("profiler: no CUDA device for a device trace: "
                           "pass device='cpu' to trace the CPU only")
    return acts + [torch.profiler.ProfilerActivity.CUDA]


@contextlib.contextmanager
def profiler(trace_dir=None, device=None):
    """Profile a region. Host spans always; with ``trace_dir`` also a
    device trace through ``torch.profiler`` (CUDA activity unless
    ``device="cpu"``), written to ``trace_dir/device_trace.json``.
    Yields a ProfileHandle usable after the block exits."""
    handle = ProfileHandle(trace_dir=trace_dir)
    prof = None
    if trace_dir is not None:
        prof = torch.profiler.profile(activities=_activities(device))
    enable_profiler()
    _tracing.start()
    if prof is not None:
        prof.__enter__()
    try:
        yield handle
    finally:
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            handle.device_trace = os.path.join(trace_dir, DEVICE_TRACE)
            prof.export_chrome_trace(handle.device_trace)
            handle.device_profile = prof
        _tracing.stop()
        handle._ts1 = _tracing.now_us()
        handle._report = disable_profiler()
