"""Device ms a page of the page program's detect half (``fn.detect``:
views, detector, decode, NMS, crops), by CUDA events recorded around it
on every page of a traced run's window; the mean over those pages."""


def read(run):
    times = run.spans.get("detect_ms")
    return sum(times) / len(times) if times else None
