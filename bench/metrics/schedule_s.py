"""Host seconds of the port's schedule precompute
(``graphs/windows.build_window_schedule`` with its ``graphs/reorder.py``
renumbering), timed on the host clock in set-up."""


def read(record: dict):
    return record["setup"].get("schedule_s")
