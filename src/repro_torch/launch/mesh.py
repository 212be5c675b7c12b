"""Production meshes of the model stack (``repro/launch/mesh.py``).

Plain descriptions (``parallel.sharding.ModelMesh``), so building one
touches no device state.  The layouts are the JAX package's TPU v5e ones,
16 x 16 = 256 chips a pod and 2 pods = 512, so that the port's dry-run
records line up with JAX's: 'data' carries batch and FSDP sharding,
'model' tensor and expert parallelism, 'pod' pure data parallelism.
"""
from __future__ import annotations

from repro_torch.parallel.sharding import ModelMesh


def make_production_mesh(*, multi_pod: bool = False) -> ModelMesh:
    """('data', 'model') 16 x 16, or ('pod', 'data', 'model') 2 x 16 x 16."""
    if multi_pod:
        return ModelMesh.of({"pod": 2, "data": 16, "model": 16})
    return ModelMesh.of({"data": 16, "model": 16})


def make_host_mesh(device=None) -> ModelMesh:
    """The degenerate 1 x 1 mesh of a single-device run."""
    return ModelMesh.of({"data": 1, "model": 1}, device)
