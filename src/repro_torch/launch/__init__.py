"""Serving of the port: family adapters, step builders and the slot-refill
serving loop (``python -m repro_torch.launch.serve``)."""
