"""The JAX package's shell scripts (``scripts/``), ported as modules run
with ``python -m eeg_multimodal_torch.scripts.<name>``."""
