"""Entry points: `repro_torch.launch.serve`, the serving launcher, and
`repro_torch.launch.train`, the training launcher."""
