"""Plain PyTorch references, float32 with TF32 off. They import nothing
of the program: they read the inputs the benchmark made and the outputs
the program gave, and work out again whatever the program derived."""
