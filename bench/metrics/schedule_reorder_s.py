"""Host seconds of the schedule precompute's first phase, ``schedule.reorder``
(canonical ids, the degree policy and the relabel), in the last schedule
built: the program's span, from its registry (set-up is not traced)."""
from bench.metrics._spans import last_s


def read(record: dict):
    return last_s(record, "schedule.reorder")
