"""Training spectra consumed by optimizer steps over the whole window."""


def read(record):
    if "samples" not in record:
        return None
    return record["samples"] / record["window_s"]
