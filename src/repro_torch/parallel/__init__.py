"""The multi-process trial mesh and the model stack's logical-axis rules
(``repro.parallel`` in PyTorch; DESIGN.md §5, §10).

  ``sharding``     ``TrialMesh`` / ``trial_mesh``: the global trial
                   domains and this process's share of them; ``ModelMesh``,
                   ``Rules`` / ``default_rules``, ``spec_for``,
                   ``sharding_ctx``: the model's logical axes on a mesh
  ``distributed``  ``torch.distributed`` over gloo, the local launcher and
                   the layout-comparison worker
                   (``python -m repro_torch.parallel.distributed``)
"""
