"""PyTorch/CUDA port of the DP-MLD framework, for one NVIDIA H100.

Mirrors the JAX package ``eeg_multimodal_tpu`` module by module (same module
names, same parameter tree) and holds against it in ``tests/test_torch_*.py``.
It imports neither JAX nor the JAX package.

- ``utils``  : device resolution (the card unless ``device="cpu"``) and seeds
- ``data``   : the reference's file loaders, stacked multimodal arrays,
               pairing, truncation, epoch batching
- ``models`` : torch-semantics layers, BERT-base, the fusion model zoo, and the
               conversion of the JAX package's parameter tree
- ``ops``    : the DP mechanism; ``ops.dp_fused`` and ``ops.attention`` wrap
               the CUDA C++ kernels of ``csrc/`` (the fused DP block and
               attention, each forward and backward), which ``ops._build``
               compiles with one nvcc call into one library; ``ops.philox``
               is the plain twin of their random bits
- ``train``  : loss and metrics, Adam, the trainer (the alternating and the
               single-optimizer steps) with ``fit``, legacy records,
               checkpoints, the ``TrainAndTest`` API, DP-SGD, the batched
               epsilon x seed sweep (``train.sweep``) and the legacy
               trainers (``train.legacy``)
- ``experiments``: the reference's experiment drivers and its legacy
               root scripts' drivers

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
