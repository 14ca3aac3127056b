"""repro_torch.serving — the serving substrate of the port: the
transformer ``ServeEngine`` (fixed-slot batched decode through
``repro_torch.models``) and the EDM server.

``EDMServer`` keeps a warm session per panel on its config's device
(the card by default) and drains requests through a worker pool with
signature coalescing and append version barriers, an LRU byte budget
over cached kNN masters, incremental library append, streaming append
subscriptions, per-panel WAL durability with crash recovery, admission
control and deadlines, and deterministic fault injection (see
``edm_server``/``scheduler``/``state``/``subscriptions``/
``durability``/``faultinject``).
"""

from repro_torch.serving.durability import Durability, PanelLog, WalError
from repro_torch.serving.edm_server import (EDMServer, run_until_terminated,
                                            serve_http)
from repro_torch.serving.engine import GenerationResult, ServeEngine
from repro_torch.serving.faultinject import FaultInjector
from repro_torch.serving.scheduler import (DeadlineExceeded, Draining,
                                           Overloaded, PanelQuarantined,
                                           Scheduler)
from repro_torch.serving.state import PanelEntry, Registry
from repro_torch.serving.subscriptions import Subscription, SubscriptionHub

__all__ = ["DeadlineExceeded", "Draining", "Durability", "EDMServer",
           "FaultInjector", "GenerationResult", "Overloaded", "PanelEntry",
           "PanelLog", "PanelQuarantined", "Registry", "Scheduler",
           "ServeEngine", "Subscription",
           "SubscriptionHub", "WalError", "run_until_terminated",
           "serve_http"]
