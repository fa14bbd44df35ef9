"""#1's share of its roofline: the least time the chip could take for every
launch in the traced searches (``counts.kernels.select_update`` at each
step's pos) over the kernel's summed device time."""

from perfbench.counts import searches

NAMES = ("select_attention_kernel",)


def read(record):
    summary, traced = record.get("trace"), record.get("traced_searches") or []
    if not summary or not traced:
        return None
    seconds, launches = searches.kernel_time(summary["ops"], NAMES)
    layers = record["config"]["model"]["decoder_layers"]
    if not launches or launches != layers * sum(s["replays"] for s in traced):
        return None
    batch, beams = record["traffic"]["batch"], record["traffic"]["beams"]
    bound = sum(searches.select_bound_s(record["config"], s, batch, beams) for s in traced)
    return 100.0 * bound / seconds
