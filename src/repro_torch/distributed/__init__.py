from repro_torch.distributed.fault_tolerance import (
    ElasticPolicy,
    StepWatchdog,
    install_preemption_handler,
)

__all__ = ["ElasticPolicy", "StepWatchdog", "install_preemption_handler"]
