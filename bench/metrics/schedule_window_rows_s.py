"""Host seconds of the schedule precompute's phase ``schedule.window_rows``
(the window tier's rows of tiles), in the last schedule built: the program's
span, from its registry (set-up is not traced)."""
from bench.metrics._spans import last_s


def read(record: dict):
    return last_s(record, "schedule.window_rows")
