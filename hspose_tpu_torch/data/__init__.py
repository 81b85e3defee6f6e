"""The train step's batched augmentation and the host input pipelines of
the train loop and the eval harness (counterpart of ``hspose_tpu/data``)."""
