"""blance_tpu_torch.parallel — the sharded solves on a mesh of ranks
(port of blance_tpu/parallel)."""
