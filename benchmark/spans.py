"""The program's own spans, for the per-layer metrics whose source is
``program_span``.

The port keeps, for each span name, the count, host seconds and device
seconds of the spans closed in the process's profiler windows
(``ddsp_tpu_torch.utils.profiling.span_totals``); the cell's traced window
is the only window a run opens.  ``tracing.summarise`` reads that table
once (``totals``), when the window has closed, into the window's
``context['spans']``, and the readers read it from there.  A span's
device seconds are its CUDA event pair's elapsed time on the stream: the
card's wall time from the end of the work queued before the span to the
end of its own, idle inside it included.  A program without the table, or
a span that recorded nothing, gives None.
"""

from __future__ import annotations

from typing import Optional


def totals() -> dict:
    """The program's span table: {name: {'count', 'host_s', 'device_s'}}."""
    from ddsp_tpu_torch.utils import profiling

    read = getattr(profiling, "span_totals", None)
    return {} if read is None else read()


def host_ms(w, name: str) -> Optional[float]:
    """Host ms a unit (hop or step) inside the span ``name``."""
    t = w.context.get("spans", {}).get(name)
    return None if t is None else 1e3 * t["host_s"] / w.units


def device_ms(w, name: str) -> Optional[float]:
    """Device ms a unit between the event pairs of the span ``name``."""
    t = w.context.get("spans", {}).get(name)
    return None if t is None or t["device_s"] is None else 1e3 * t["device_s"] / w.units
