from .metrics import (
    calc_sampling_metrics,
    clean_sample,
    reject_sample,
    token_accuracy,
)

__all__ = ["calc_sampling_metrics", "clean_sample", "reject_sample", "token_accuracy"]
