"""Command-line entry points:

    python -m dirjax_torch.test_dir  — benchmark evaluation
    python -m dirjax_torch.index     — build / query a dense serving index
    python -m dirjax_torch.serve     — serve an index (see dirjax_torch.serve)
"""
