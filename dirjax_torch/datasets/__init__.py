"""dirjax.datasets — benchmark datasets, combinators, registry.

The port's own copy of ``dirjax/datasets/__init__.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

``create("Oxford5K")`` / ``create("ImageList('list.txt')")`` instantiate
datasets by name through an explicit registry (no eval()-DSL).
"""

from .base import Dataset, find_and_list_classes, find_relevants  # noqa: F401
from .generic import (  # noqa: F401
    ImageClusters,
    ImageList,
    ImageListLabels,
    ImageListLabelsQ,
    ImageListRelevants,
    ImageListROIs,
    ImagesAndLabels,
    LabelledDataset,
    NullCluster,
)
from .combinators import (  # noqa: F401
    CatDataset,
    CropDataset,
    DeployedDataset,
    SubDataset,
    deploy,
    deploy_and_split,
    split,
)
from .registry import available, create, db_root, register  # noqa: F401
from . import benchmarks  # noqa: F401  (registers Oxford5K, Paris6K, ...)
from .benchmarks import *  # noqa: F401,F403
from .synthetic import (  # noqa: F401
    Synthetic,
    SyntheticLabels,
    make_synthetic_benchmark,
)
from .downloader import download_dataset  # noqa: F401

# generic types are also creatable by name from the CLI
for _cls in (ImageList, ImageListLabels, ImageListLabelsQ, ImageListRelevants,
             ImageClusters, NullCluster):
    register(_cls)
