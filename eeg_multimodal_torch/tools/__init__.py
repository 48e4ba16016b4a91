"""The JAX package's ``tools/``, ported, each a module run with ``python -m
eeg_multimodal_torch.tools.<name>``: the step roofline, the attention table,
the bf16-moment validation, the fused-DP NaN repro, ``r5_modal_seeds`` and
the ``r5_accuracy`` pipeline, run on the card; ``import_hf_bert`` and
``recover_vocab``, run on the host; and the DP forward's layout probe."""
