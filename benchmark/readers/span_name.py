"""One span's device time a request or a step, from the program's spans
(``spans.py``): the busy (``part="busy"``) or idle (``part="idle"``)
seconds charged to the span of that full name (``trainer.allreduce``, not
the layer ``trainer`` that ``span_layer`` sums) in the profiled
sub-window, over the root spans started in it, in ms. None when the window
holds no root span, or no time under that span (a program without it)."""
from .. import spans


def read(ctx, span: str, part: str):
    tr = spans.of(ctx)
    if tr is None or not tr.roots:
        return None
    if span not in tr.busy_s and span not in tr.idle_s:
        return None
    table = tr.busy_s if part == "busy" else tr.idle_s
    return 1e3 * table.get(span, 0.0) / tr.roots
