"""Training substrate of the port: step construction + fault-tolerant
loop (``repro_torch.training.carry`` carries a reference train state)."""

from repro_torch.training.loop import train
from repro_torch.training.step import make_train_step

__all__ = ["train", "make_train_step"]
