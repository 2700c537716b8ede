"""Synthetic MetaTool/ToolBench-like benchmarks and the synthetic LM token
pipeline (copies of `repro.data`)."""
