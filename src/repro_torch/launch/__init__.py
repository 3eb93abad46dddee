"""Entry points: `python -m repro_torch.launch.serve` / `.train`."""
