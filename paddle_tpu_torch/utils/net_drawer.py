"""Program -> Graphviz dot (reference ``fluid/net_drawer.py`` /
``python/paddle/utils/make_model_diagram.py``): the model-diagram
utility. Emits dot text (render with any graphviz install); no binary
dependency.

The port's copy of ``paddle_tpu/utils/net_drawer.py``: it imports
nothing of that package, and gives the same results.
"""

__all__ = ["draw_program", "save_dot"]

_OP_STYLE = 'shape=box, style="rounded,filled", fillcolor="#e8f0fe"'
_PARAM_STYLE = 'shape=oval, style=filled, fillcolor="#fef3e2"'
_VAR_STYLE = "shape=oval"


def _esc(name):
    return name.replace('"', r'\"')


def draw_program(program, block_idx=0, max_label=40):
    """Return graphviz dot text for one block of a Program: op nodes
    (boxes) wired through their input/output variables (ovals;
    parameters tinted)."""
    block = program.blocks[block_idx]
    lines = ["digraph program {", "  rankdir=TB;"]
    seen_vars = {}

    def var_node(name):
        if name in seen_vars:
            return seen_vars[name]
        nid = "var_%d" % len(seen_vars)
        seen_vars[name] = nid
        v = block.var_or_none(name)
        from ..core.framework import Parameter
        style = _PARAM_STYLE if isinstance(v, Parameter) else _VAR_STYLE
        label = name if len(name) <= max_label else \
            name[:max_label - 3] + "..."
        shape = getattr(v, "shape", None)
        if shape:
            label += r"\n%s" % (tuple(shape),)
        lines.append('  %s [label="%s", %s];' % (nid, _esc(label),
                                                 style))
        return nid

    for i, op in enumerate(block.ops):
        op_id = "op_%d" % i
        lines.append('  %s [label="%s", %s];'
                     % (op_id, _esc(op.type), _OP_STYLE))
        for names in op.inputs.values():
            for n in names:
                if n and n != "@EMPTY@":
                    lines.append("  %s -> %s;" % (var_node(n), op_id))
        for names in op.outputs.values():
            for n in names:
                if n and n != "@EMPTY@":
                    lines.append("  %s -> %s;" % (op_id, var_node(n)))
    lines.append("}")
    return "\n".join(lines)


def save_dot(program, path, block_idx=0):
    dot = draw_program(program, block_idx=block_idx)
    with open(path, "w") as f:
        f.write(dot)
    return path
