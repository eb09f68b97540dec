"""Alias so ``python -m dirjax_torch.fit_whitening`` matches
``python -m dirjax.fit_whitening``."""

from .cli.fit_whitening import build_parser, main  # noqa: F401

if __name__ == "__main__":
    main()
