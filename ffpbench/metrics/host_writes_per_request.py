"""The program's ``repro_torch.host_write`` spans -- tensors of the delay
model copied to the table's device on the request path -- per traced
request.  None where the program records no ``repro_torch.place`` span
(it then has neither span to read)."""
from ffpbench import spans


def read(record):
    if not spans.per_request(record, "repro_torch.place"):
        return None
    return spans.per_request(record, "repro_torch.host_write")
