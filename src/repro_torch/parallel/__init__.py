"""The multi-process trial mesh (``repro.parallel`` in PyTorch; DESIGN.md
§10).

  ``sharding``     ``TrialMesh`` / ``trial_mesh``: the global trial
                   domains and this process's share of them
  ``distributed``  ``torch.distributed`` over gloo, the local launcher and
                   the layout-comparison worker
                   (``python -m repro_torch.parallel.distributed``)
"""
