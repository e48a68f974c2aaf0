"""The SSL training slice on one device: ``build_train_setup`` and its
step (``dinov3_tpu/train``)."""

from dinov3_tpu_torch.train.setup import TrainSetup, build_train_setup
from dinov3_tpu_torch.train.ssl_meta_arch import SSLMetaArch
from dinov3_tpu_torch.train.train_step import TrainState, make_train_step, put_batch

__all__ = ["SSLMetaArch", "TrainSetup", "TrainState", "build_train_setup",
           "make_train_step", "put_batch"]
