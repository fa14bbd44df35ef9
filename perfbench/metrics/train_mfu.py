"""The whole train step's share of the bf16 peak: forward and backward
(3 x forward) model operations on the valid tokens of the window's steps,
over the window's time."""

from perfbench.counts import model, peaks, searches


def read(record):
    steps = record.get("train_steps")
    if not steps:
        return None
    config, flops = record["config"], 0.0
    for i in steps:
        batch = record["batches"][i]
        mask = batch["encoder_mask"]
        tokens, width = searches.patch_tokens(config, mask)
        flops += 3 * model.train_forward(config, mask.sum(axis=1),
                                         batch["decoder_mask"].sum(axis=1), tokens, width)
    return 100.0 * flops / record["window_s"] / peaks.PEAK_BF16_FLOPS
