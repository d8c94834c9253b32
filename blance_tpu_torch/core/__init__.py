"""blance_tpu_torch.core — the port's own copies of the jax-free data model
and host encode/decode."""
