from .bound import lower_bound
from .parametrizers import NonNegativeParametrizer
from .rounding import ste_round

__all__ = ["ste_round", "lower_bound", "NonNegativeParametrizer"]
