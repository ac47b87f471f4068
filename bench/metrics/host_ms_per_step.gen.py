"""Host ms to enqueue one ``serve_step`` on the benchmark's clock, the
launch queue drained before each (no sync inside the call): the median of
the traced run's few such steps."""

import statistics


def read(out):
    s = out.window.get("host_step_s")
    return 1e3 * statistics.median(s) if s else None
