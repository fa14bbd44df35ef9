"""Device milliseconds of a decode's prologue (the encoder, the cross K/V
projection and the state reset), as the beam search's own events on the
stream time it (``prologue_ms`` of its ``stats``), averaged over the
window's searches; None where the program reports no such time."""


def read(record):
    times = [s["prologue_ms"] for s in record.get("searches") or [] if "prologue_ms" in s]
    if not times:
        return None
    return sum(times) / len(times)
