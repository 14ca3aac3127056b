"""Distributed runtime of the port: the sharded CCM engines on
``torch.distributed`` (``sharded_ccm``: one process a rank over a named
``DeviceMesh``, zero collectives while computing) and the fault-tolerance
hooks of the journaled runner (``fault``: preemption guard, straggler
monitor, heartbeat)."""

from repro_torch.distributed.fault import (Heartbeat, PreemptionGuard,
                                           StragglerMonitor)
from repro_torch.distributed.sharded_ccm import (
    gather_host,
    make_ccm_mesh,
    pad_to_multiple,
    sharded_ccm_convergence,
    sharded_ccm_matrix,
    sharded_optimal_E,
    sharded_smap_matrix,
    sharded_smap_theta,
)

__all__ = ["Heartbeat", "PreemptionGuard", "StragglerMonitor", "gather_host",
           "make_ccm_mesh", "pad_to_multiple", "sharded_ccm_convergence",
           "sharded_ccm_matrix", "sharded_optimal_E", "sharded_smap_matrix",
           "sharded_smap_theta"]
