"""Device ms a page of the page program's embed half (``fn.embed``: the
ViT tower over the page's crops), by CUDA events recorded around it on
every page of a traced run's window; the mean over those pages."""


def read(run):
    times = run.spans.get("embed_ms")
    return sum(times) / len(times) if times else None
