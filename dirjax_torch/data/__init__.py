"""The port's own copy of ``dirjax/data/__init__.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.
"""

from . import geometry, transforms  # noqa: F401
from .loader import (  # noqa: F401
    BalancedSampler,
    Batch,
    SampleLoader,
    array2img,
    get_loader,
    iterate_batches,
    load_one_img,
    test_loader_speed,
)
