"""One closed-loop caller: the next call is issued when the last one's
results are on the card, as a pipeline that reads its matching does.

Each call is timed from issue to ``sync()`` on the host clock; calls repeat
until ``seconds`` have passed since the first one began (at least one
call), and the window ends when the last call ends.
"""
from __future__ import annotations

import contextlib
import time
import traceback
from typing import Callable, Optional


def run(call: Callable, seconds: float,
        keep: Callable[[int, object, float], None],
        sync: Callable[[], None],
        span: Optional[Callable[[], contextlib.AbstractContextManager]] = None
        ) -> dict:
    """Returns ``{"latencies_s", "window_s", "calls", "failed", "errors",
    "last"}``: ``last`` is the last call's output (``None`` if it raised);
    ``keep(i, out, seconds)`` sees each call's output and length after its
    time is taken."""
    span = span or contextlib.nullcontext
    latencies, errors = [], []
    failed, last = 0, None
    t0 = time.perf_counter()
    t1 = t0
    i = 0
    while i == 0 or t1 - t0 < seconds:
        start = time.perf_counter()
        try:
            with span():
                last = call()
                sync()
        except Exception:  # a failed call counts; the window goes on
            failed += 1
            last = None
            if len(errors) < 3:
                errors.append(traceback.format_exc())
        t1 = time.perf_counter()
        latencies.append(t1 - start)
        if last is not None:
            keep(i, last, t1 - start)
        i += 1
    return {"latencies_s": latencies, "window_s": t1 - t0, "calls": i,
            "failed": failed, "errors": errors, "last": last}
