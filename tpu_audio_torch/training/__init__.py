"""Whisper fine-tuning (port of tpu_audio/training/)."""

from tpu_audio_torch.training.data import Batcher, Example, evaluate, featurize, shard, train
from tpu_audio_torch.training.whisper import make_train_step

__all__ = ["make_train_step", "Batcher", "Example", "featurize", "shard",
           "evaluate", "train"]
