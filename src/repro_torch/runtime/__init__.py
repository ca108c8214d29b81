from .recovery import (ElasticPlan, HeartbeatMonitor, StragglerPolicy,
                       TrainSupervisor, derive_elastic_mesh)
