"""Host ms a ``skipper_match`` call spends in the kernels' id range checks
(the spans ``kernels.id_check``), each of which waits for the card."""
from bench.metrics._spans import ms_a_call


def read(record: dict):
    return ms_a_call(record, "skipper_match", "kernels.id_check")
