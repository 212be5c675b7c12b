"""Host time of the program's ``repro_torch.prepare`` spans (a request's
entry up to its first chunk: checks, saturation depths, the card layout,
placing the delay and offsets, the zero summary; its reads to the host
included), in ms, per traced request."""
from ffpbench import spans


def read(record):
    return spans.per_request(record, "repro_torch.prepare", host_ms=True)
