from repro_torch.distributed.collectives import compressed_psum, cross_pod_grad_reduce
from repro_torch.distributed.fault_tolerance import (
    ElasticPolicy,
    StepWatchdog,
    install_preemption_handler,
)
from repro_torch.distributed.sharding import (
    batch_pspec,
    cache_pspecs,
    opt_state_pspecs,
    param_pspec,
    report_replicated,
    tiered_pspecs,
    tree_pspecs,
)

__all__ = [
    "compressed_psum", "cross_pod_grad_reduce", "ElasticPolicy",
    "StepWatchdog", "install_preemption_handler", "batch_pspec",
    "cache_pspecs", "opt_state_pspecs", "param_pspec", "report_replicated",
    "tiered_pspecs", "tree_pspecs",
]
