"""Entry points of the port: ``python -m repro_torch.launch.serve`` replays
a dynamic workload through the online serving runtime."""
