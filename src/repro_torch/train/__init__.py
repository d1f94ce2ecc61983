"""LM training of the port (``repro.train``): the microbatched train and
eval steps and the checkpointed, heartbeat-monitored training loop."""
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: F401
from repro_torch.train.trainer import TrainLoopConfig, train_loop  # noqa: F401
