"""Linear-leaf tables for prediction (PyTorch port of
``lightgbm_tpu/linear``; the leaf fit comes with the training slice)."""
