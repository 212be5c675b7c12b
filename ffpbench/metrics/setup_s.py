"""From the harness's first statement to the first timed request: imports,
the kernel library (built on a checkout's first run), the mask table and a
warm-up request of the cell's own shape."""


def read(record):
    return record["setup_s"]
