"""Alias so ``python -m dirjax_torch.index`` matches ``python -m dirjax.index``:
build/query a serving index from ``.npy`` descriptor files."""

from .cli.index import build_parser, main  # noqa: F401

if __name__ == "__main__":
    main()
