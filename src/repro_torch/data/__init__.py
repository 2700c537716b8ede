"""Synthetic MetaTool/ToolBench-like benchmarks (copy of `repro.data`)."""
