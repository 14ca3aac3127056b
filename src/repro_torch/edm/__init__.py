"""repro_torch.edm — the session API of the port.

* ``EDMConfig`` — frozen, validated hyperparameters (with ``device``).
* ``Dataset``  — a screened (N, L) panel on the session's device
  (``series``, cached ``embedding``); ``series_stats`` / ``merge_stats``
  are its running screening statistics.
* ``EDM``      — the session: ``optimal_E`` / ``simplex`` / ``ccm`` /
  ``surrogate_test`` / ``ccm_batch`` / ``xmap`` / ``submit_panel``, each
  dispatched through a ``Plan`` that reuses the session's cached multi-E
  kNN master.
* ``MatrixRunner`` / ``run_key`` — the journal of ``EDM.xmap(run_dir=)``
  (``edm.runner``; ``python -m repro_torch.edm.inspect <run_dir>`` reads
  it).
* ``make_surrogates`` — null ensembles for ``EDM.surrogate_test``.
* ``carry_session_cache`` — install a reference session's master and
  optimal-E sweep in a port session.
"""

from repro_torch.edm.carry import carry_session_cache
from repro_torch.edm.config import DEFAULT_THETAS, INVALID_POLICIES, EDMConfig
from repro_torch.edm.dataset import (Dataset, merge_stats, screen_panel,
                                     series_stats)
from repro_torch.edm.plan import Plan
from repro_torch.edm.runner import (PREEMPTED_EXIT, MatrixRunner, RunState,
                                    run_key)
from repro_torch.edm.session import EDM, PanelResult, SurrogateResult
from repro_torch.edm.surrogates import make_surrogates

__all__ = ["DEFAULT_THETAS", "EDM", "EDMConfig", "Dataset",
           "INVALID_POLICIES", "MatrixRunner", "PREEMPTED_EXIT",
           "PanelResult", "Plan", "RunState", "SurrogateResult",
           "carry_session_cache", "make_surrogates", "merge_stats",
           "run_key", "screen_panel", "series_stats"]
