"""repro_torch.edm — the session API of the port.

* ``EDMConfig`` — frozen, validated hyperparameters (with ``device``).
* ``Dataset``  — a screened (N, L) panel on the session's device.
* ``EDM``      — the session: ``optimal_E`` / ``simplex`` / ``ccm_batch``
  / ``xmap`` / ``submit_panel``, each dispatched through a ``Plan`` that
  reuses the session's cached multi-E kNN master.
* ``carry_session_cache`` — install a reference session's master and
  optimal-E sweep in a port session.
"""

from repro_torch.edm.carry import carry_session_cache
from repro_torch.edm.config import DEFAULT_THETAS, INVALID_POLICIES, EDMConfig
from repro_torch.edm.dataset import Dataset, screen_panel
from repro_torch.edm.plan import Plan
from repro_torch.edm.session import EDM, PanelResult

__all__ = ["DEFAULT_THETAS", "EDM", "EDMConfig", "Dataset",
           "INVALID_POLICIES", "PanelResult", "Plan", "carry_session_cache",
           "screen_panel"]
