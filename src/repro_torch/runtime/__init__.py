"""Training runtime of the port (``repro.runtime`` without ``elastic``,
whose re-meshing needs more than one card)."""
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 StragglerPolicy,
                                                 SupervisorReport,
                                                 TrainSupervisor)
