"""Fault-tolerance substrate of the port (``repro.distributed``
counterpart): the liveness and straggler policies the serving engine runs
on its step clock, and the training loop's elastic plan and supervisor.
The JAX package's mesh and sharding modules wait for later slices."""
from repro_torch.distributed.fault_tolerance import (ElasticPlan,
                                                     HeartbeatMonitor,
                                                     StragglerPolicy,
                                                     TrainSupervisor)

__all__ = ["ElasticPlan", "HeartbeatMonitor", "StragglerPolicy",
           "TrainSupervisor"]
