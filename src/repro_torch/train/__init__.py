"""The port's training loop (port of ``repro.train``)."""

from .loop import TrainState, Trainer, make_train_step

__all__ = ["TrainState", "Trainer", "make_train_step"]
