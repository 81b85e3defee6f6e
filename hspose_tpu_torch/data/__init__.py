"""The train step's batched augmentation and the eval harness's host input
pipeline (counterpart of ``hspose_tpu/data``)."""
