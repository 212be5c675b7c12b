"""PyTorch/CUDA port of the Fast Flexible Paxos quorum-space evaluator.

The port mirrors the sub-packages of the JAX package ``repro`` and imports
nothing of it.  Its main path is the streamed race over the quorum space:

  ``frontier.score_systems`` -> ``montecarlo.streaming`` chunk loop ->
  ``montecarlo.engine`` draws + tally + decide -> ``StreamSummary`` sketch ->
  ``frontier.pareto.pareto_mask``

with the quorum-tally kernels (``kernels/quorum_tally``) written by hand in
CUDA C++ for Hopper.  Entry points run on the card unless the caller passes
``device="cpu"`` (see ``repro_torch.device``).
"""
