"""Entry points: `repro_torch.launch.serve`, the serving launcher,
`repro_torch.launch.train`, the training launcher, and
`repro_torch.launch.dryrun`, the host-only dry-run of the production
meshes (with `mesh`, `specs`, `state_specs`, `hbm_model` and
`hlo_analysis`)."""
