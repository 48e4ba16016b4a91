"""The (data, model) mesh: data parallelism and Megatron tensor parallelism
over ``torch.distributed`` ranks (the JAX package's ``parallel/``)."""
