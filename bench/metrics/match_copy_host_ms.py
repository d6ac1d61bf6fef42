"""Host ms a ``skipper_match`` call spends in its ``put``s of the schedule
(the spans ``skipper_match.copy``), less the time the card spends in them
on kernels queued before: the staging and the pageable copies alone, not
the wait for the tiers that a copy takes with it."""
from bench.metrics._spans import ms_a_call


def read(record: dict):
    return ms_a_call(record, "skipper_match", "skipper_match.copy",
                     less_device_work=True)
