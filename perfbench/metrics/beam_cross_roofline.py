"""#2's share of its roofline: the least time the chip could take for every
launch in the traced searches (``counts.kernels.cross``, valid keys only)
over the device time of its kernels (the one-pass form, or both launches
of the split form)."""

from perfbench.counts import searches

NAMES = ("cross_attention_kernel", "cross_stats_kernel", "cross_value_kernel")


def read(record):
    summary, traced = record.get("trace"), record.get("traced_searches") or []
    if not summary or not traced:
        return None
    seconds, launches = searches.kernel_time(summary["ops"], NAMES)
    layers = record["config"]["model"]["decoder_layers"]
    calls = layers * sum(s["replays"] for s in traced)
    if not launches or launches not in (calls, 2 * calls):
        return None
    beams = record["traffic"]["beams"]
    masks = [record["pool_masks"][i] for i in record["traced_pool_index"]]
    bound = sum(searches.cross_bound_s(record["config"], s, m, beams)
                for s, m in zip(traced, masks))
    return 100.0 * bound / seconds
