"""Distributed training (PyTorch port of ``lightgbm_tpu/parallel``): the
data, feature and voting parallel tree learners over a
``torch.distributed`` process group (``mesh.py``) and the process-group
bootstrap (``distributed.py``)."""
