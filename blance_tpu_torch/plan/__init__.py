"""blance_tpu_torch.plan — the dense planner on PyTorch."""
