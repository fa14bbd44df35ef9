"""Flash #5's share of its roofline in the decode prologue: the least time
the chip could take for the forwards of the traced searches' prologues
(``counts.flash``, valid keys only) over the device time of the flash
forward kernels in the trace. None unless the trace's launches equal what
the searches' ``prologue_flash_launches`` say, and they say at least one:
a program that does not count them, or a prologue on the plain route."""

from perfbench.counts import flash, searches

NAMES = ("flash_fwd",)


def read(record):
    summary, traced = record.get("trace"), record.get("traced_searches") or []
    if not summary or not traced:
        return None
    counted = [s.get("prologue_flash_launches") for s in traced]
    if any(n is None for n in counted) or sum(counted) < 1:
        return None
    seconds, launches = searches.kernel_time(summary["ops"], NAMES)
    if launches != sum(counted) or seconds <= 0:
        return None
    masks = [record["pool_masks"][i] for i in record["traced_pool_index"]]
    bound = sum(flash.prologue_bound_s(record["config"], m, n) for m, n in zip(masks, counted))
    return 100.0 * bound / seconds
