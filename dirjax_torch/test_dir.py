"""Alias so ``python -m dirjax_torch.test_dir`` matches
``python -m dirjax.test_dir``."""

from .cli.test_dir import build_parser, main  # noqa: F401
from .extraction import eval_model, extract_image_features  # noqa: F401

if __name__ == "__main__":
    main()
