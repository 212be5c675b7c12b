"""Host time of the program's ``repro_torch.place`` spans (the delay
model's tensors placed on the mask table's device, inside a request's
``repro_torch.prepare``), in ms, per traced request.  None where the
program has no such span (a delay that holds tensors records one a
request)."""
from ffpbench import spans


def read(record):
    v = spans.per_request(record, "repro_torch.place", host_ms=True)
    return v or None
