"""blance_tpu_torch.utils: host clock, crash-atomic writes, phase timing."""
