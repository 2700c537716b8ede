"""Backend training: the train step (`train_step`) and the loop with its
checkpoints (`trainer`). Counterpart of `repro/training`."""
