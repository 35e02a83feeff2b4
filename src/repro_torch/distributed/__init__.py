"""Fault-tolerance substrate of the port (``repro.distributed``
counterpart): the liveness and straggler policies the serving engine runs
on its step clock, the training loop's elastic plan and supervisor, and
the sharding rules (`repro_torch.distributed.sharding`)."""
from repro_torch.distributed.fault_tolerance import (ElasticPlan,
                                                     HeartbeatMonitor,
                                                     StragglerPolicy,
                                                     TrainSupervisor)

__all__ = ["ElasticPlan", "HeartbeatMonitor", "StragglerPolicy",
           "TrainSupervisor"]
