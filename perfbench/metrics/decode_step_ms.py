"""Device milliseconds a decode step takes: the beam search's own events
from the prologue's end to the last step's end (``steps_ms`` of its
``stats``, the waits between steps included) over its replayed steps,
summed over the window's searches; None where the program reports no such
time."""


def read(record):
    searches = [s for s in record.get("searches") or [] if "steps_ms" in s]
    replays = sum(s["replays"] for s in searches)
    if not replays:
        return None
    return sum(s["steps_ms"] for s in searches) / replays
