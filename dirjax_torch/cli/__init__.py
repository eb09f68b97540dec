"""Command-line entry points:

    python -m dirjax_torch.test_dir         — benchmark evaluation
    python -m dirjax_torch.extract_features — descriptors of a dataset to .npy
    python -m dirjax_torch.fit_whitening    — fit a PCA-whitening into a checkpoint
    python -m dirjax_torch.extract_kapture  — kapture global features (needs kapture)
    python -m dirjax_torch.index            — build / query a dense serving index
    python -m dirjax_torch.serve            — serve an index (see dirjax_torch.serve)
    python -m dirjax_torch.train            — fine-tune a descriptor model
"""
