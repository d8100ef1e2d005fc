"""What the generation scheduler needs of the reference's micro-batching
front door (``paddle_tpu/serving/batcher.py``): the overload error, the
queue-wait EWMA constant and the one Future-resolution helper every
serving path funnels through.

The micro-batcher itself (``MicroBatcher``, ``TenantQuotaError``) is not
ported yet (ROADMAP Queue A, "Inference export and the serving
engine").
"""

from ..observability import flight as _flight

__all__ = ["ServingOverloadError"]


class ServingOverloadError(RuntimeError):
    """Admission refused: the bounded queue stayed full past the submit
    timeout, or the projected queue wait exceeds the deadline budget."""


# EWMA smoothing for observed queue waits (~ the last ten admissions
# dominate, so the projection tracks load swings without flapping)
_WAIT_ALPHA = 0.2


def _resolve(future, result=None, exception=None):
    """Set a Future's outcome without letting a client-side cancel()
    (racing the cancelled() check) raise InvalidStateError and kill the
    dispatcher thread.

    Every exceptional resolution of the serving tier funnels through
    here, which makes it the flight recorder's one hook for a
    client-visible error: armed, a failure storm auto-dumps one
    debounced post-mortem bundle; disarmed, it is one attribute
    check."""
    if exception is not None:
        _flight.RECORDER.client_error(exception)
    try:
        if not future.cancelled():
            if exception is not None:
                future.set_exception(exception)
            else:
                future.set_result(result)
    except Exception:
        pass  # already cancelled or resolved: the client walked away
