"""Host milliseconds spent dispatching a decode step: the beam search's own
``dispatch_s`` over its ``replays``, summed over the window's searches."""


def read(record):
    searches = record.get("searches") or []
    replays = sum(s["replays"] for s in searches)
    if not replays:
        return None
    return 1e3 * sum(s["dispatch_s"] for s in searches) / replays
