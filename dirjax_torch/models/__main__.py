"""List available architectures (the port's copy of
``dirjax/models/__main__.py``, which it mirrors; reference ``python -m
dirtorch.nets``)."""

from . import model_names

if __name__ == "__main__":
    print("Available architectures:")
    for name in model_names():
        print("  " + name)
