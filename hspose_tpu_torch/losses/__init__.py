"""The four loss families of the train step (counterpart of ``hspose_tpu/losses``)."""

from hspose_tpu_torch.losses.fs_net_loss import fs_net_loss
from hspose_tpu_torch.losses.geometry_loss import geo_transform_loss
from hspose_tpu_torch.losses.organize import control_loss
from hspose_tpu_torch.losses.prop_loss import prop_rot_loss
from hspose_tpu_torch.losses.recon_loss import recon_6face_loss

__all__ = ["fs_net_loss", "geo_transform_loss", "control_loss", "prop_rot_loss",
           "recon_6face_loss"]
