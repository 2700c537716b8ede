"""Backend model pool: configs, params, layers, the SSD block and the model
programs (counterparts of `repro/models/`)."""
