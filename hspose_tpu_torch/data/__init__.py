"""Batched augmentation of the train step (counterpart of ``hspose_tpu/data``)."""
