"""The program's ``repro_torch.host_read`` spans -- device-to-host reads on
the request path, each a synchronisation -- per traced request."""
from ffpbench import spans


def read(record):
    return spans.per_request(record, "repro_torch.host_read")
