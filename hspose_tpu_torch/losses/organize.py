"""Loss-set selection per training stage (counterpart of
``hspose_tpu/losses/organize.py``)."""

from __future__ import annotations


def control_loss(train_stage: str):
    if train_stage == "PoseNet_only":
        name_fs_list = ["Rot1", "Rot2", "Rot1_cos", "Rot2_cos", "Rot_regular",
                        "Tran", "Size", "R_con"]
        name_recon_list = ["Per_point", "Point_voting"]
        name_geo_list = ["Geo_point"]
        name_prop_list = ["Prop_pm", "Prop_sym"]
    else:
        raise NotImplementedError(train_stage)
    return name_fs_list, name_recon_list, name_geo_list, name_prop_list
