"""Host seconds of the schedule precompute's phase ``schedule.split`` (the
split into dense windows and the global tier's edges), in the last schedule
built: the program's span, from its registry (set-up is not traced)."""
from bench.metrics._spans import last_s


def read(record: dict):
    return last_s(record, "schedule.split")
