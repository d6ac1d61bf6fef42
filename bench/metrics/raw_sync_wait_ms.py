"""Host ms a raw-stream ``skipper`` call spends in the global-tier
kernel's id range check (the span ``kernels.id_check``), which waits for
the card."""
from bench.metrics._spans import ms_a_call


def read(record: dict):
    return ms_a_call(record, "skipper", "kernels.id_check")
