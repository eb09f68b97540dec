"""The port's dataset layer: dirjax's benchmark datasets, registry and
synthetic fixture. They are framework-free host code shared with the JAX
package (importing them leaves jax out of ``sys.modules``), so the port
names them here instead of copying them. This is the one door to them:
``cli/test_dir.py`` and ``chip_smoke.py`` (which imports nothing of the JAX
package itself) go through it."""

from dirjax.datasets import (  # noqa: F401
    Synthetic,
    create,
    download_dataset,
    make_synthetic_benchmark,
)
