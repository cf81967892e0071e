"""A layer's device time a request or a step, from the program's spans
(``spans.py``): the busy (``part="busy"``) or idle (``part="idle"``)
seconds charged to the layer's spans in a profiled sub-window of the cell's
traffic, over the root spans (``server.predict``, ``server.launch``,
``trainer.step``) started in it, in ms. None when the window holds no root
span (a program without spans)."""
from .. import spans


def read(ctx, layer: str, part: str):
    tr = spans.of(ctx)
    if tr is None or not tr.roots:
        return None
    return 1e3 * tr.layer_s(layer, part) / tr.roots
