"""Distributed runtime of the port. So far its fault-tolerance hooks
(``fault``: preemption guard, straggler monitor, heartbeat), which the
journaled runner uses; the sharded engines are not ported yet (ROADMAP
queue 1, item 9)."""

from repro_torch.distributed.fault import (Heartbeat, PreemptionGuard,
                                           StragglerMonitor)

__all__ = ["Heartbeat", "PreemptionGuard", "StragglerMonitor"]
