"""One problem = one λ path of ``lasso_path``, driven exactly as the
``lasso_path`` task drives it (the same entry point, options and batched
execution).  The task stands apart for its reference,
``cdbench/reference/lasso_path_wide.py``, whose working set suits a design
with far more columns than rows."""

from .lasso_path import prepare, solve  # noqa: F401
