"""Seconds from the process's start to the first timed call: imports, the
card's start, the kernels' build or load, the inputs, the entry point's
own set-up (the schedule) and the warm call."""


def read(window: dict):
    return window["setup_s"]
