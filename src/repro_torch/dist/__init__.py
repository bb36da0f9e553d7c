"""Supervision of the port (``repro.dist``): `StepWatchdog`, which the
partition service arms around every solve. ``TrainSupervisor`` waits for
ROADMAP.md Queue A item 14b (training), and the mesh path (``Plan``, the
sharded partitioner, the distributed sort and graph) for item 13."""
from repro_torch.dist.ft import StepWatchdog  # noqa: F401
