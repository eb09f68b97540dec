"""dirjax_torch — the PyTorch/CUDA port of dirjax for one NVIDIA H100.

It mirrors ``dirjax``'s module names so each counterpart is easy to find,
imports ``torch`` and never ``jax``, and reuses dirjax's framework-free host
code (``dirjax.datasets``, ``dirjax.data``, ``dirjax.utils.evaluation``,
``dirjax.server``).
Every TPU kernel on the ported path is a CUDA kernel written by hand for
Hopper (``csrc/``), built with nvcc at first use (``kernels/build.py``).

Layout:
    dirjax_torch.models   — ResNet backbones + R-MAC descriptor head (nn.Modules)
    dirjax_torch.ops      — GeM, fused head kernel wrapper, whitening, AQE,
                            ranking, top-k kernel wrappers (ops.topk)
    dirjax_torch.serving  — RetrievalIndex: the dense serving index
    dirjax_torch.serve    — the index server (dirjax.server in front of it)
    dirjax_torch.utils    — checkpoint I/O (.pt reference schema, dirjax .npz)
    dirjax_torch.cli      — command-line entry points (test_dir, index)
    dirjax_torch.kernels  — nvcc build of csrc/*.cu, ctypes loading
"""

__version__ = "0.1.0"
