"""Delay models for the reference, one module a configuration's
``delay.kind`` (found by ``find.piece("delays", kind)``):
``sample(gen, shape, hop, cfg)`` returns float32 one-way delays in ms drawn
from ``gen``, in the order and by the arithmetic the configuration's model
states, so that a generator in the same state gives the same draws as the
program's.  ``hop`` names the message leg (proposal, to_learner,
from_coordinator, to_coordinator).  A new delay model is a new module
here."""
