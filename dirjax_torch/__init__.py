"""dirjax_torch — the PyTorch/CUDA port of dirjax for one NVIDIA H100.

It mirrors ``dirjax``'s module names so each counterpart is easy to find,
imports ``torch`` and never ``jax``, and imports nothing of the JAX package:
it carries its own copies of dirjax's framework-free host modules
(``datasets``, ``data``, ``utils.evaluation``, ``server``, ``tuning``).
Every TPU kernel on the ported path is a CUDA kernel written by hand for
Hopper (``csrc/``), built with nvcc at first use (``kernels/build.py``).

Layout:
    dirjax_torch.models   — ResNet backbones + R-MAC descriptor head (nn.Modules)
    dirjax_torch.ops      — GeM, fused head kernel wrapper, whitening, AQE,
                            ranking, top-k kernel wrappers (ops.topk), ITQ
                            binary codes and their kernels (ops.binary), PQ/OPQ
                            and the ADC kernels (ops.pq), IVF-ADC (ops.ivf)
    dirjax_torch.serving  — RetrievalIndex (dense), BinaryIndex, PQIndex and
                            IVFPQIndex
    dirjax_torch.tuning   — recall auto-tuning of nprobe / rerank_factor
    dirjax_torch.server   — dynamic batcher, socket server, client
    dirjax_torch.serve    — the index server's command line
    dirjax_torch.loss     — AP, tie-aware AP and triplet losses
    dirjax_torch.train    — descriptor training (fit, steps, optimizers, CLI)
    dirjax_torch.datasets — benchmark datasets, registry, synthetic fixture
    dirjax_torch.data     — host decode, transforms and batching
    dirjax_torch.utils    — checkpoint I/O (.pt reference schema, dirjax .npz),
                            evaluation (mAP)
    dirjax_torch.cli      — command-line entry points (test_dir, index, train, ...)
    dirjax_torch.kernels  — nvcc build of csrc/*.cu, ctypes loading
"""

__version__ = "0.1.0"
