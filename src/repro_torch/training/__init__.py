"""Training of the port: optimizers, gradient compression, synthetic data,
checkpoints committed through the control plane, and the trainer
(``repro/training`` in PyTorch)."""
