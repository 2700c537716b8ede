"""Entry points: `repro_torch.launch.serve`, the serving launcher."""
