"""Training of the port (the counterpart of ``repro.training``): the
synthetic token stream, AdamW with bf16 moments, int8 gradient
compression, checkpoints without msgpack, the fault-tolerant
:class:`~repro_torch.training.trainer.Trainer`, and the train step as one
captured CUDA graph, :class:`~repro_torch.training.graphs.CapturedTrainStep`
(the reference's jitted step)."""
