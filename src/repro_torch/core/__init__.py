"""repro_torch.core — the EDM compute primitives under the session facade:
embedding conventions, all-kNN search, simplex projection and optimal-E
search, convergent cross mapping (the convergence engine, the
library-batched all-pairs engine and the per-series ``ccm_group``), S-Map
(the batched Gram engine), and the streaming co-moments of ``stats``."""

from repro_torch.core.ccm import (auto_batch_libs, ccm_convergence,
                                  ccm_convergence_caps, ccm_group,
                                  ccm_group_batched, ccm_matrix, cross_map,
                                  cross_map_sizes_seed, drive_batched,
                                  normalize_lib_sizes)
from repro_torch.core.embedding import (delay_embed, embed_offset,
                                        num_embedded, pred_rows)
from repro_torch.core.knn import KnnTable, all_knn
from repro_torch.core.simplex import (optimal_E, optimal_E_batch,
                                      optimal_E_sweep_seed, rho_curve,
                                      simplex_predict, simplex_skill)
from repro_torch.core.smap import (nonlinearity_test, smap_predict,
                                   smap_predict_seed, smap_skill)
from repro_torch.core.smap_engine import (DEFAULT_THETAS, smap_cross_map,
                                          smap_fit, smap_group,
                                          smap_jacobian, smap_matrix,
                                          smap_predict_batch,
                                          smap_theta_sweep)
from repro_torch.core.stats import CoMoments, pearson_rows

__all__ = ["CoMoments", "DEFAULT_THETAS", "KnnTable", "all_knn",
           "auto_batch_libs", "ccm_convergence", "ccm_convergence_caps",
           "ccm_group", "ccm_group_batched", "ccm_matrix", "cross_map",
           "cross_map_sizes_seed", "delay_embed", "drive_batched",
           "embed_offset", "normalize_lib_sizes", "nonlinearity_test",
           "num_embedded", "optimal_E", "optimal_E_batch",
           "optimal_E_sweep_seed", "pearson_rows", "pred_rows", "rho_curve",
           "simplex_predict", "simplex_skill",
           "smap_cross_map", "smap_fit", "smap_group", "smap_jacobian",
           "smap_matrix", "smap_predict", "smap_predict_batch",
           "smap_predict_seed", "smap_skill", "smap_theta_sweep"]
