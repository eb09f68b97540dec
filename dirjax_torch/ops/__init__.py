from .gem_head import fused_gem_head, gem_head_reference  # noqa: F401
from .ivf import (IVFArrays, bin_ivf, build_ivf, ivf_assign,  # noqa: F401
                  ivf_topk, train_ivf, unbin_ivf)
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
from .pq import (encode_pq, pq_lookup, pq_pad_codes, pq_scores,  # noqa: F401
                 pq_topk, reconstruct_pq, train_opq, train_pq)
from .qe import (  # noqa: F401
    expand_database,
    expand_database_chunked,
    expand_descriptors,
    expand_queries,
    expand_queries_chunked,
    expand_queries_quantized,
)
from .ranking import compute_scores, compute_scores_chunked, rank_topk  # noqa: F401
from .residual_norm import fused_residual_norm, residual_norm_reference  # noqa: F401
from .topk import quantize_db, rank_topk_fused  # noqa: F401
from .whitening import (PCAParams, apply_whitening, fit_pca,  # noqa: F401
                        fit_pca_device, whitening_matrix)
