"""Partial-order graph plot (`-g`): a Graphviz .dot file, rendered to png or
pdf where `dot` is on PATH.

Counterpart of `abpoa_tpu/io/plot.py` (abPOA src/abpoa_plot.c:34-122): the
same node colours, labels, aligned-node same-rank groups and dashed
mismatch links, so the .dot file is byte-identical.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

from .. import constants as C
from ..params import Params

NODE_COLOR = ["pink1", "red1", "gold2", "seagreen4", "gray"]  # ACGTN
FONT_SIZE = 24


def dump_pog(ab, abpt: Params) -> None:
    """Write `abpt.out_pog`.dot for `ab`'s graph, then render it."""
    g = ab.graph
    if getattr(g, "is_native", False):
        g = g.to_python()
    if not g.is_topological_sorted:
        g.topological_sort(abpt)
    out = abpt.out_pog
    dot_fn = out + ".dot"
    decode = abpt.code_to_char
    labels = {}
    with open(dot_fn, "w") as fp:
        fp.write(f"// abpoa graph dot file.\n// {g.node_n} nodes.\n")
        fp.write('digraph ABPOA_graph {\n\tgraph [rankdir="LR"];\n'
                 "\tnode [width=1.000000, style=filled, fixedsize=true, "
                 "shape=circle];\n")
        for i in range(g.node_n):
            nid = int(g.index_to_node_id[i])
            if nid in (C.SRC_NODE_ID, C.SINK_NODE_ID):
                base = "S" if nid == C.SRC_NODE_ID else "E"
                color = NODE_COLOR[4]
            else:
                base = chr(decode[g.nodes[nid].base])
                color = NODE_COLOR[min(g.nodes[nid].base, 4)]
            labels[nid] = f'"{base}\\n{i}"'
            fp.write(f"{labels[nid]} [color={color}, fontsize={FONT_SIZE}]\n")
        x_index = -1
        for i in range(g.node_n):
            nid = int(g.index_to_node_id[i])
            node = g.nodes[nid]
            for j, out_id in enumerate(node.out_ids):
                fp.write(f'\t{labels[nid]} -> {labels[out_id]} '
                         f'[label="{node.out_w[j]}", fontsize=20, fontcolor=red, '
                         f'penwidth={node.out_w[j] + 1}]\n')
            if node.aligned_ids:
                fp.write(f"\t{{rank=same; {labels[nid]} ")
                for a in node.aligned_ids:
                    fp.write(f"{labels[a]} ")
                fp.write("};\n")
                if i > x_index:
                    x_index = i
                    fp.write(f"\t{{ edge [style=dashed, arrowhead=none]; {labels[nid]} ")
                    for a in node.aligned_ids:
                        fp.write(f"-> {labels[a]} ")
                        x_index = max(x_index, int(g.node_id_to_index[a]))
                    fp.write("}\n")
        fp.write("}\n")
    ext = os.path.splitext(out)[1].lstrip(".")
    if ext not in ("pdf", "png"):
        raise SystemExit("POG can only be dumped to a .pdf/.png file")
    if shutil.which("dot") is None:
        print(f"Warning: graphviz 'dot' not found; wrote {dot_fn} only.",
              file=sys.stderr)
        return
    with open(out, "wb") as ofp:
        subprocess.run(["dot", dot_fn, f"-T{ext}"], stdout=ofp, check=True)
