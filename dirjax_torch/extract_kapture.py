"""Alias so ``python -m dirjax_torch.extract_kapture`` matches
``python -m dirjax.extract_kapture``."""

from .cli.extract_kapture import (  # noqa: F401
    build_parser,
    extract_kapture_global_features,
    main,
)

if __name__ == "__main__":
    main()
