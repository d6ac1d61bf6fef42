"""Device ms a call spends copying from the host to the card: the
schedule's arrays, which ``skipper_match`` moves on every call. The sum of
the trace's host-to-device copies in the window over the traced calls."""


def read(record: dict):
    copies = [e["dur"] for e in record["device"]
              if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    if not copies or not record["calls"]:
        return None
    return sum(copies) / len(record["calls"]) / 1e3
