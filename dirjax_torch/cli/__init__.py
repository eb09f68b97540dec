"""Command-line entry points:

    python -m dirjax_torch.test_dir  — benchmark evaluation
"""
