"""blance_tpu_torch.moves: the move calculus (host oracle and batched diff)."""
