"""Training runtime of the port (``repro.runtime``): the supervisor, its
failure injection and straggler policy, and the elastic restart's plan and
re-sharding."""
from repro_torch.runtime.elastic import (ElasticPlan, make_mesh_from_plan,
                                         plan_elastic_restart, reshard_state)
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 StragglerPolicy,
                                                 SupervisorReport,
                                                 TrainSupervisor)
