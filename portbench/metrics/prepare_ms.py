"""prepare_ms: self time per call of the engines' `prepare` (pack,
upload, layout), the outermost span ending in a synchronise. Left out
where no prepare span opened."""

from statistics import fmean


def read(run):
    spans = run.spans or []
    if not any("prepare" in c for c in spans):
        return None
    return fmean(c.get("prepare", 0.0) for c in spans) * 1e3
