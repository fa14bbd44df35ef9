"""Set-up: process start to the first timed unit (import, CUDA context,
kernel library, weights, the cell's shapes warmed and captured)."""


def read(record):
    return record["setup_s"]
