"""Training of the port (the counterpart of ``repro.training``): the
synthetic token stream, AdamW with bf16 moments, int8 gradient
compression, checkpoints without msgpack, and the fault-tolerant
:class:`~repro_torch.training.trainer.Trainer`."""
