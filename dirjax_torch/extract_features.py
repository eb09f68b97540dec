"""Alias so ``python -m dirjax_torch.extract_features`` matches
``python -m dirjax.extract_features``."""

from .cli.extract_features import build_parser, extract_features, main  # noqa: F401

if __name__ == "__main__":
    main()
