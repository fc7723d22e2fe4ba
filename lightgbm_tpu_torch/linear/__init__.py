"""Piecewise-linear leaf trees (PyTorch port of ``lightgbm_tpu/linear``).

- :mod:`fit` -- after a tree's leaves are final, every leaf's Gram sums
  in one pass (``csrc/linear_gram.cu`` on the card, a plain torch twin on
  the host) and one batched ``torch.linalg.solve_ex``. The host NumPy
  loop in ``boosting.GBDT._fit_linear_tree`` stays as the host learner's
  oracle (``linear_device=auto`` or ``off`` on the host; ``off`` is
  refused on a CUDA device).
- :mod:`pack` -- slot-ordered per-leaf coefficient tables for prediction.
"""
from .fit import (fit_leaves, fit_leaves_plain, fit_linear_leaves,
                  gram_sums, gram_sums_plain, leaf_feature_table)
from .pack import linear_pack_arrays, linear_values_by_row

__all__ = ["fit_leaves", "fit_leaves_plain", "fit_linear_leaves",
           "gram_sums", "gram_sums_plain", "leaf_feature_table",
           "linear_pack_arrays", "linear_values_by_row"]
