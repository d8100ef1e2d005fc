"""Gradient clipping appended as ops (reference ``paddle_tpu/clip.py``):
by value (``clip``), by each gradient's norm (``clip_by_norm``) and by
the global norm of all of them (``squared_l2_norm`` of each, ``sum``,
``sqrt``, ``elementwise_max`` with the clip norm, then each gradient
times ``clip_norm / max(global_norm, clip_norm)``), set on parameters
(``ParamAttr(gradient_clip=)``, ``set_gradient_clip(clip, params)``) or
for the process (``set_gradient_clip(clip)``)."""

from .core import unique_name

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "append_gradient_clip_ops",
           "set_gradient_clip"]

_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    """Set a process-global clip strategy, or with ``param_list`` attach
    it to those parameters."""
    global _global_clip
    if param_list:
        for p in param_list:
            p.gradient_clip = clip
    else:
        _global_clip = clip


class GradientClipByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, param, grad):
        block = grad.block
        out = block.create_var(
            name=unique_name.generate("%s.clip" % grad.name),
            shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op("clip", inputs={"X": [grad.name]},
                        outputs={"Out": [out.name]},
                        attrs={"min": self.min, "max": self.max},
                        infer_shape=False)
        return out


class GradientClipByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, param, grad):
        block = grad.block
        out = block.create_var(
            name=unique_name.generate("%s.clip" % grad.name),
            shape=grad.shape, dtype=grad.dtype, stop_gradient=True)
        block.append_op("clip_by_norm", inputs={"X": [grad.name]},
                        outputs={"Out": [out.name]},
                        attrs={"max_norm": self.clip_norm},
                        infer_shape=False)
        return out


class GradientClipByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``, as ops of the training step."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_all(self, params_grads):
        live = [(p, g) for p, g in params_grads if g is not None]
        if not live:
            return params_grads
        block = live[0][1].block
        dtype = live[0][1].dtype
        sq_names = []
        for p, g in live:
            sq = block.create_var(
                name=unique_name.generate("%s.sq" % g.name), shape=[],
                dtype=g.dtype, stop_gradient=True)
            block.append_op("squared_l2_norm", inputs={"X": [g.name]},
                            outputs={"Out": [sq.name]}, infer_shape=False)
            sq_names.append(sq.name)
        total = block.create_var(name=unique_name.generate("global_norm_sq"),
                                 shape=[], dtype=dtype, stop_gradient=True)
        block.append_op("sum", inputs={"X": sq_names},
                        outputs={"Out": [total.name]}, infer_shape=False)
        gnorm = block.create_var(name=unique_name.generate("global_norm"),
                                 shape=[], dtype=dtype, stop_gradient=True)
        block.append_op("sqrt", inputs={"X": [total.name]},
                        outputs={"Out": [gnorm.name]}, infer_shape=False)
        denom = block.create_var(name=unique_name.generate("clip_denom"),
                                 shape=[], dtype=dtype, stop_gradient=True)
        clip_const = block.create_var(
            name=unique_name.generate("clip_const"), shape=[], dtype=dtype,
            stop_gradient=True)
        block.append_op("fill_constant", outputs={"Out": [clip_const.name]},
                        attrs={"shape": [], "dtype": dtype,
                               "value": self.clip_norm}, infer_shape=False)
        block.append_op("elementwise_max",
                        inputs={"X": [gnorm.name], "Y": [clip_const.name]},
                        outputs={"Out": [denom.name]}, infer_shape=False)
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            new_g = g.block.create_var(
                name=unique_name.generate("%s.gclip" % g.name),
                shape=g.shape, dtype=g.dtype, stop_gradient=True)
            factor = g.block.create_var(
                name=unique_name.generate("%s.factor" % g.name),
                shape=g.shape, dtype=g.dtype, stop_gradient=True)
            g.block.append_op("elementwise_mul",
                              inputs={"X": [g.name], "Y": [clip_const.name]},
                              outputs={"Out": [factor.name]},
                              infer_shape=False)
            g.block.append_op("elementwise_div",
                              inputs={"X": [factor.name],
                                      "Y": [denom.name]},
                              outputs={"Out": [new_g.name]},
                              infer_shape=False)
            out.append((p, new_g))
        return out


def append_gradient_clip_ops(params_grads):
    """Clip each gradient by its parameter's clip, else the global one;
    a global-norm clip on any parameter (or globally) clips them all
    jointly. Returns the new (parameter, gradient) pairs."""
    clips = set(getattr(p, "gradient_clip", None) for p, _ in params_grads)
    gclips = [c for c in clips
              if isinstance(c, GradientClipByGlobalNorm)] or (
        [_global_clip] if isinstance(_global_clip,
                                     GradientClipByGlobalNorm) else [])
    if gclips:
        return gclips[0]._clip_all(params_grads)
    out = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip", None) or _global_clip
        if g is None or clip is None or \
                getattr(g, "selected_rows", None) is not None:
            out.append((p, g))
        else:
            out.append((p, clip._clip(p, g)))
    return out
