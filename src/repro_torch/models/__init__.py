# The simulator's testbeds (convex logistic regression and a small MLP) and
# the GQA decoder LM the serving engine runs (layers, attention,
# transformer): plain functions on dict trees in the JAX package's layout.
from repro_torch.models import logreg, mlp

__all__ = ["logreg", "mlp"]
