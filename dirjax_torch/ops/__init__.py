from .gem_head import fused_gem_head, gem_head_reference  # noqa: F401
from .normalize import l2_normalize  # noqa: F401
from .pooling import (  # noqa: F401
    avg_pool,
    center_bias_mask,
    gem_pool,
    global_pool,
    mac_pool,
    pool_descriptors,
    sympow,
    sympow_pool,
)
from .qe import expand_database, expand_queries  # noqa: F401
from .ranking import compute_scores, compute_scores_chunked, rank_topk  # noqa: F401
from .whitening import (PCAParams, apply_whitening, fit_pca,  # noqa: F401
                        whitening_matrix)
