"""repro_torch.core — the EDM compute primitives under the session facade
(main-path subset: embedding conventions and the batched CCM engine)."""

from repro_torch.core.ccm import (auto_batch_libs, ccm_group_batched,
                                  drive_batched)
from repro_torch.core.embedding import embed_offset, num_embedded, pred_rows

__all__ = ["auto_batch_libs", "ccm_group_batched", "drive_batched",
           "embed_offset", "num_embedded", "pred_rows"]
