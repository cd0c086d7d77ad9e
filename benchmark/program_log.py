"""The program's own spans and counters in the traced window: the span
log of ``tpu_faas_torch/obs/profile.py`` (``SPAN_LOG``), which the
resident scheduler fills while a ``torch.profiler`` capture runs, entries
``(name, start, end)`` for a span and ``(name, stamp, value)`` for a
counter on the harness's clock (``time.perf_counter``). A program without
that log, or a window it holds nothing of, reads None."""

from __future__ import annotations


def entries(ctx, name: str) -> list[tuple] | None:
    """The log's entries named ``name`` that start in the window, first
    intake to last resolve; None where there are none."""
    try:
        from tpu_faas_torch.obs import profile
    except ImportError:
        return None
    log = getattr(profile, "SPAN_LOG", None)
    if log is None or len(ctx.stamps) == 0:
        return None
    lo, hi = ctx.stamps[0, 0], ctx.stamps[-1, 3]
    got = [e for e in list(log.entries) if e[0] == name and lo <= e[1] <= hi]
    return got or None


def span_ms(ctx, name: str) -> float | None:
    """The window's total milliseconds in span ``name`` over its ticks."""
    got = entries(ctx, name)
    if got is None:
        return None
    return 1e3 * sum(e[2] - e[1] for e in got) / len(ctx.ticks)


def counter_values(ctx, name: str) -> list | None:
    got = entries(ctx, name)
    return None if got is None else [e[2] for e in got]
