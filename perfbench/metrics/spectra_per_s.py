"""Spectra whose K ranked candidates reached the caller as host arrays,
over the whole window."""


def read(record):
    if "spectra" not in record:
        return None
    return record["spectra"] / record["window_s"]
