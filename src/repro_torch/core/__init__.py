"""repro_torch.core — the EDM compute primitives under the session facade:
embedding conventions, all-kNN search, simplex projection and optimal-E
search, and convergent cross mapping (the convergence engine and the
library-batched all-pairs engine)."""

from repro_torch.core.ccm import (auto_batch_libs, ccm_convergence,
                                  ccm_convergence_caps, ccm_group_batched,
                                  ccm_matrix, cross_map, cross_map_sizes_seed,
                                  drive_batched, normalize_lib_sizes)
from repro_torch.core.embedding import (delay_embed, embed_offset,
                                        num_embedded, pred_rows)
from repro_torch.core.knn import KnnTable, all_knn
from repro_torch.core.simplex import (optimal_E, optimal_E_batch,
                                      optimal_E_sweep_seed, rho_curve,
                                      simplex_predict, simplex_skill)

__all__ = ["KnnTable", "all_knn", "auto_batch_libs", "ccm_convergence",
           "ccm_convergence_caps", "ccm_group_batched", "ccm_matrix",
           "cross_map", "cross_map_sizes_seed", "delay_embed",
           "drive_batched", "embed_offset", "normalize_lib_sizes",
           "num_embedded", "optimal_E", "optimal_E_batch",
           "optimal_E_sweep_seed", "pred_rows", "rho_curve",
           "simplex_predict", "simplex_skill"]
