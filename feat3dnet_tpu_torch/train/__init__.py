"""Weakly supervised triplet training of the port."""
from feat3dnet_tpu_torch.train.loss import alignment_triplet_loss
from feat3dnet_tpu_torch.train.trainer import (Trainer, TrainState, init_state,
                                               make_chained_train_step,
                                               make_fused_train_step, make_optimizer,
                                               make_train_step)

__all__ = ["TrainState", "Trainer", "alignment_triplet_loss", "init_state",
           "make_chained_train_step", "make_fused_train_step", "make_optimizer",
           "make_train_step"]
