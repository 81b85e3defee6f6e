"""The eval harness of the port (counterpart of ``hspose_tpu/evaluation``):
``evaluate.py`` (batched inference, the CLI), ``eval_dataset.py``,
``metrics.py`` and the native matchers."""
