"""The program's spans and counters, one registry for the process.

``span(name)`` times a step of the program on the host clock, always: it
adds one to the span's count and its seconds to the span's total and last
values. While a ``torch.profiler`` records, it also opens
``torch.profiler.record_function(name)``, so that the step lies in the
profiler's trace beside the kernels it launched, on the profiler's clock.
The profiler is the only switch and the only exporter: nothing here reads
the environment or writes a file.

``spanned(name)`` puts every call of a function inside ``span(name)``.
``count(name, n)`` adds to a host integer counter, always.
``count_device(name, t)`` adds a device scalar without waiting for the
card, and only while a profiler records (off a profiler, nothing is
computed or allocated). ``counters()`` reads both kinds, the device ones
with one wait; ``spans()`` returns the spans' totals; ``reset()`` clears
everything, ``reset(names)`` the named counters.

Names are dotted: an entry point's top span (``skipper_match``,
``skipper``), its steps (``skipper_match.copy``, ...), and shared steps by
their module (``kernels.id_check``, ``kernels.build``, ``schedule.*``).
Kernel launches are the counters ``launches.<kernel>``.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, Iterable, Union

import torch

#: name -> [count, total seconds, last seconds]
_SPANS: Dict[str, list] = {}
_COUNTS: Dict[str, int] = {}
#: device accumulators of ``count_device``, int64 scalars
_DEVICE: Dict[str, torch.Tensor] = {}


def recording() -> bool:
    """True while a profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()


class span:
    """``with span(name):`` times the block; see the module doc."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.rf = None
        if recording():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        rec = _SPANS.get(self.name)
        if rec is None:
            _SPANS[self.name] = [1, dt, dt]
        else:
            rec[0] += 1
            rec[1] += dt
            rec[2] = dt
        if self.rf is not None:
            self.rf.__exit__(*exc)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def count_device(name: str, t: Union[torch.Tensor, int]) -> None:
    """While a profiler records, add ``t`` (a scalar tensor, summed on its
    device without a wait, or a host integer) to the counter ``name``."""
    if not recording():
        return
    if not isinstance(t, torch.Tensor):
        count(name, t)
        return
    t = t.detach().to(torch.int64)
    acc = _DEVICE.get(name)
    _DEVICE[name] = t if acc is None else acc + t.to(acc.device)


def counters() -> Dict[str, int]:
    """Every counter: the host ones, plus the device ones read with one
    wait for the card."""
    out = dict(_COUNTS)
    if _DEVICE:
        names = list(_DEVICE)
        dev = _DEVICE[names[0]].device
        both = torch.stack([_DEVICE[k].to(dev) for k in names])
        values = both.tolist()  # host-sync: ok — the one read of them all
        for k, v in zip(names, values):
            out[k] = out.get(k, 0) + v
    return out


def launched(kernel: str) -> None:
    """One launch of ``kernel``: the counter ``launches.<kernel>``."""
    count(f"launches.{kernel}")


def launches(kernels: Iterable[str]) -> Dict[str, int]:
    """Launches of each of ``kernels`` since its last reset (a host read,
    no wait)."""
    return {k: _COUNTS.get(f"launches.{k}", 0) for k in kernels}


def spans() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "total_s", "last_s"}}`` of every span so far."""
    return {k: {"count": c, "total_s": total, "last_s": last}
            for k, (c, total, last) in _SPANS.items()}


def reset(names: Iterable[str] = None) -> None:
    """Clear the counters ``names`` (set to 0), or, without ``names``,
    every span and counter."""
    if names is None:
        _SPANS.clear()
        _COUNTS.clear()
        _DEVICE.clear()
        return
    for k in names:
        _COUNTS[k] = 0
        _DEVICE.pop(k, None)
