"""Expression-tree rendering: indented text, graphviz dot, and a png
through the ``graphviz`` package where it is installed.

Counterpart of dprox_tpu/linop/visualize.py; both packages give the same
strings for the same tree.
"""
from __future__ import annotations

from .base import Constant, LinOp, Placeholder, Variable


def _label(op: LinOp) -> str:
    if isinstance(op, Variable):
        return f"Variable({op.name})"
    if isinstance(op, Placeholder):
        return f"Placeholder({op.name})"
    if isinstance(op, Constant):
        return f"Constant{tuple(op.value.shape)}"
    extra = f" x{op.scalar:g}" if hasattr(op, "scalar") else ""
    return f"{type(op).__name__}{extra}"


def to_text(op: LinOp, indent: int = 0) -> str:
    """One line a node, each child indented two spaces below its parent."""
    lines = ["  " * indent + _label(op)]
    for c in op.children:
        lines.append(to_text(c, indent + 1))
    return "\n".join(lines)


def to_dot(op: LinOp) -> str:
    """graphviz dot source of the tree, edges from child to parent; a
    shared subexpression is one node."""
    lines = ["digraph linop {", "  rankdir=BT;"]
    seen = {}

    def walk(node):
        if id(node) in seen:
            return seen[id(node)]
        nid = f"n{len(seen)}"
        seen[id(node)] = nid
        lines.append(f'  {nid} [label="{_label(node)}"];')
        for c in node.children:
            lines.append(f"  {walk(c)} -> {nid};")
        return nid

    walk(op)
    lines.append("}")
    return "\n".join(lines)


def visualize(op: LinOp, filename: str = None) -> str:
    """The tree's dot source; with ``filename``, also ``filename.png``
    rendered by graphviz, or ``filename.dot`` where graphviz cannot
    render."""
    dot = to_dot(op)
    if filename:
        try:
            import graphviz

            graphviz.Source(dot).render(filename, format="png", cleanup=True)
        except (ImportError, RuntimeError, OSError):  # no package or no dot executable
            with open(filename + ".dot", "w") as f:
                f.write(dot)
    return dot
