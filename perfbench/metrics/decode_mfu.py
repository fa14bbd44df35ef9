"""The whole decode's share of the bf16 peak: model operations of the
window's searches (encoder, cross K/V, every step of B x K rows through the
decoder and the lm_head) over the window's time."""

from perfbench.counts import peaks, searches


def read(record):
    stats = record.get("searches") or []
    if not stats or "pool_masks" not in record:
        return None
    beams = record["traffic"]["beams"]
    flops = sum(searches.search_flops(record["config"], st, record["pool_masks"][i], beams)
                for st, i in zip(stats, record["unit_pool_index"]))
    return 100.0 * flops / record["window_s"] / peaks.PEAK_BF16_FLOPS
