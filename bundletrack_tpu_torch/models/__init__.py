"""Networks other than the keypoint frontend (VOS mask propagation), and
the training steps of both networks."""

from bundletrack_tpu_torch.frontend.lfnet import LFNet, MSODetector, SimpleDesc, init_lfnet
from bundletrack_tpu_torch.models.lfnet_train import LFNetTrainBatch, lfnet_loss, make_lfnet_train_step
from bundletrack_tpu_torch.models.optim import cosine_lr, cosine_schedule, make_adam
from bundletrack_tpu_torch.models.vos_train import (
    VOSTrainBatch,
    make_vos_train_step,
    vos_loss,
    vos_rollout_loss,
)

__all__ = [
    "LFNet",
    "MSODetector",
    "SimpleDesc",
    "init_lfnet",
    "LFNetTrainBatch",
    "lfnet_loss",
    "make_lfnet_train_step",
    "cosine_lr",
    "cosine_schedule",
    "make_adam",
    "VOSTrainBatch",
    "make_vos_train_step",
    "vos_loss",
    "vos_rollout_loss",
]
