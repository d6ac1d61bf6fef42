"""Host seconds of the schedule precompute's phase ``schedule.gather_map``
(``stream_src``, from decision slots back to stream order), in the last
schedule built: the program's span, from its registry (set-up is not
traced)."""
from bench.metrics._spans import last_s


def read(record: dict):
    return last_s(record, "schedule.gather_map")
