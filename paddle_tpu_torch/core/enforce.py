"""Structured error discipline — the enforce layer (reference
``paddle_tpu/core/enforce.py``, copied: it is plain Python).

Parity with reference ``paddle/platform/enforce.h`` (PADDLE_ENFORCE*,
``EnforceNotMet`` carrying message + call-site) and
``paddle/utils/Error.h``: a single exception type the framework raises
for contract violations, carrying the formatted message and the
caller's file:line so a failure inside a step still names the op and
variable that broke.
"""

import inspect

__all__ = ["EnforceNotMet", "enforce", "enforce_eq", "enforce_gt",
           "enforce_not_none"]


class EnforceNotMet(RuntimeError):
    """Reference EnforceNotMet (enforce.h:55): message + call site."""

    def __init__(self, message, site=None):
        self.site = site
        super().__init__("%s (at %s)" % (message, site)
                         if site else message)


def _site(depth=2):
    fr = inspect.stack()[depth]
    return "%s:%d" % (fr.filename.rsplit("/", 1)[-1], fr.lineno)


def enforce(cond, fmt="enforce failed", *args):
    if not cond:
        raise EnforceNotMet(fmt % args if args else fmt, _site())


def enforce_eq(a, b, fmt=None, *args):
    if a != b:
        msg = "expected %r == %r" % (a, b) if fmt is None else \
            (fmt % args if args else fmt)
        raise EnforceNotMet(msg, _site())


def enforce_gt(a, b, fmt=None, *args):
    if not a > b:
        msg = "expected %r > %r" % (a, b) if fmt is None else \
            (fmt % args if args else fmt)
        raise EnforceNotMet(msg, _site())


def enforce_not_none(v, fmt="unexpected None", *args):
    if v is None:
        raise EnforceNotMet(fmt % args if args else fmt, _site())
    return v
