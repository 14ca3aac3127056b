"""Carry a reference session's state into a port session.

EDM has no weights; a session's state is its kNN master
``(dists, idx, k_master, levels)`` and its cached ``(E_opt, rho)``
optimal-E sweep. ``carry_session_cache`` takes that state as numpy arrays
(a ``repro.edm.EDM`` session's ``_cache`` converted with ``np.asarray``)
and installs it in a ``repro_torch`` session bound to the same panel, so
that both compute ``xmap`` from the same master. A carried master may be
grown by ``EDM.append`` like one the session built: the grown tables are
the bits the reference's ``EDM.append`` gives.
"""

from __future__ import annotations

import numpy as np
import torch


def carry_session_cache(session, cache: dict):
    """Install ``cache`` ({"master": (dM, iM, k_m, levels), "rho":
    (E_opt, rho)}, either key optional) in ``session``; returns it.

    Shapes and types are checked against the session's panel: dM/iM are
    (N, levels, L, k_m) float32/int32, E_opt (N,), rho (N, E_max).
    """
    N, L = session.data.N, session.data.L
    if "master" in cache:
        dM, iM, k_m, levels = cache["master"]
        dM = np.asarray(dM, np.float32)
        iM = np.asarray(iM)
        want = (N, int(levels), L, int(k_m))
        if dM.shape != want or iM.shape != want:
            raise ValueError(f"master tables {dM.shape}/{iM.shape} do not "
                             f"match the session's panel: want {want}")
        if not np.issubdtype(iM.dtype, np.integer):
            raise ValueError(f"master indices must be integers, got "
                             f"{iM.dtype}")
        session._cache["master"] = (
            torch.tensor(dM, device=session.device),
            torch.tensor(iM.astype(np.int32), device=session.device),
            int(k_m), int(levels))
    if "rho" in cache:
        E_opt, rho = cache["rho"]
        E_opt = np.asarray(E_opt, np.int32)
        rho = np.asarray(rho, np.float32)
        if E_opt.shape != (N,) or rho.shape != (N, session.config.E_max):
            raise ValueError(
                f"(E_opt, rho) shapes {E_opt.shape}, {rho.shape} do not "
                f"match N={N}, E_max={session.config.E_max}")
        session._cache["rho"] = (E_opt, rho)
    return session
