"""Passes a traffic mix names under ``"pass"``, one module each, found by
``find.piece("passes", name)``.  A pass module holds both sides of one
kind of request:

``program(streaming, table, delay, traffic, device, **kw)``
    the program's entry for one request: a function of the request's key
    that calls ``streaming`` (the program's module) on set-up's mask table
    and delay model with the common keywords ``kw`` (n, trials, chunk,
    precision, shard) and returns the ``StreamSummary``;
``draws(ref, gen)``
    the reference's draws of one chunk from the chunk's generator, in the
    order the program sends its messages (``ref`` is the ``Reference``);
``decide(ref, draws)``
    the reference's (S, M) latency and fast / recovery / undecided bits of
    a block of those draws.

A new pass is a new module here.
"""
