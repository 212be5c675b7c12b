"""Oracle for the SSD scan: the O(S) sequential recurrence (independent of
the chunked algorithm the kernel implements)."""
from __future__ import annotations

from repro_torch.models.ssm import ssd_reference


def ssd(xw, da, Bm, Cm, init_state=None):
    """xw (B,S,nh,hd), da (B,S,nh), Bm/Cm (B,S,ds) ->
    (y (B,S,nh,hd), final_state (B,nh,hd,ds))."""
    return ssd_reference(xw, da, Bm, Cm, init_state)
