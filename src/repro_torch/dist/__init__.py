"""The port's ``repro.dist``: `StepWatchdog`, which the partition service
arms around every solve and the train loop around every step,
`TrainSupervisor`, and the mesh path of the partitioner on
``torch.distributed``: `Plan` (``sharding``), the collective helper
(``comm``), the distributed sample sort (``sort``), the memory-sharded
graph storage (``graph``), the sharded and raced V-cycle drivers
(``partition``) and a launcher of local ranks (``spawn``)."""
from repro_torch.dist.ft import StepWatchdog, TrainSupervisor  # noqa: F401
from repro_torch.dist.sharding import Plan, make_mesh  # noqa: F401
